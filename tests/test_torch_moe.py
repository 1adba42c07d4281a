"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` on the same numpy-made inputs and weights.

Tolerances: in f32 the routing must agree exactly (same experts, same
slot ranks, same drops) and the outputs within 2e-5 of the largest; in
bf16 (the model's dtype) within 2e-2 of the largest, the kernel tests'
bf16 tolerance.  Both configs run at their reduced widths with their own
routing (the reduced configs cap it at top-2 of 4): mixtral top-2 of 8
experts, dbrx top-4 of 16.  A capacity factor of 0.5 makes experts
overflow, so slots are dropped."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import moe as jax_moe
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import moe

torch.set_num_threads(1)

# (arch, capacity factor)
CASES = [("mixtral-8x7b", 1.25), ("mixtral-8x7b", 0.5),
         ("dbrx-132b", 1.25), ("dbrx-132b", 0.5)]


def _cfgs(arch, cf):
    full = get_config(arch)
    cut = dict(num_experts=full.num_experts,
               num_experts_per_tok=full.num_experts_per_tok,
               moe_capacity_factor=cf)
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)), **cut),
            dataclasses.replace(reduced(get_config(arch)), **cut))


def _np_params(cfg, seed):
    rng = np.random.default_rng(seed)
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {"router": rng.standard_normal((d, e)) / np.sqrt(d),
            "gate": rng.standard_normal((e, d, ff)) / np.sqrt(d),
            "up": rng.standard_normal((e, d, ff)) / np.sqrt(d),
            "down": rng.standard_normal((e, ff, d)) / np.sqrt(ff)}


def _run_both(arch, cf, dtype, shape=(2, 24), seed=0):
    jcfg, cfg = _cfgs(arch, cf)
    np_p = _np_params(cfg, seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    jp = {n: jnp.asarray(a, jnp.float32 if n == "router" else jdt)
          for n, a in np_p.items()}
    tp = {n: torch.from_numpy(a.astype(np.float32)).to(
        torch.float32 if n == "router" else tdt) for n, a in np_p.items()}
    want = jax_moe._moe_dense(jcfg, jp, jnp.asarray(x, jdt))
    got = moe.moe_block(cfg, tp, torch.from_numpy(x).to(tdt))
    return cfg, jcfg, jp, tp, x, got, want


def _rel(got, want):
    w = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - w).max()
                 / (np.abs(w).max() + 1e-9))


def _jax_slots(jcfg, jp, x):
    """The reference's routing intermediates, recomputed with its ops."""
    xt = jnp.asarray(x, jnp.float32).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt @ jp["router"], axis=-1)
    top_w, top_e = jax.lax.top_k(probs, jcfg.num_experts_per_tok)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, jcfg.num_experts, dtype=jnp.int32)
    rank = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    c = jax_moe.capacity(jcfg, xt.shape[0])
    return np.asarray(top_e), np.asarray(rank), np.asarray(rank < c)


@pytest.mark.parametrize("arch,cf", CASES)
def test_moe_dense_matches_jax_f32(arch, cf):
    cfg, jcfg, jp, tp, x, got, want = _run_both(arch, cf, "f32")
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) < 2e-5
    # the routing agrees exactly: experts, slot ranks and drops
    top_e, rank, keep = _jax_slots(jcfg, jp, x)
    _w, t_top_e = moe.route(cfg, tp, torch.from_numpy(x).reshape(
        -1, cfg.d_model))
    flat_e, t_rank, t_keep = moe.dispatch_slots(
        cfg, t_top_e, moe.capacity(cfg, x.shape[0] * x.shape[1]))
    assert np.array_equal(t_top_e.numpy(), top_e)
    assert np.array_equal(t_keep.numpy(), keep)
    assert np.array_equal(t_rank.numpy(), np.where(keep, rank, 0))
    assert (int((~t_keep).sum()) > 0) == (cf < 1.0)


@pytest.mark.parametrize("arch,cf", CASES)
def test_moe_dense_matches_jax_bf16(arch, cf):
    *_, got, want = _run_both(arch, cf, "bf16", shape=(1, 40), seed=3)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < 2e-2


def test_dropped_slots_add_nothing():
    """A token whose every slot is dropped comes out as zeros, as in the
    reference."""
    cfg, jcfg, jp, tp, x, got, want = _run_both("mixtral-8x7b", 0.5, "f32",
                                                shape=(1, 64))
    _top_e, _rank, keep = _jax_slots(jcfg, jp, x)
    gone = ~keep.reshape(-1, cfg.num_experts_per_tok).any(-1)
    assert gone.any()
    assert not got.reshape(-1, cfg.d_model)[torch.from_numpy(gone)].any()
    assert not np.asarray(want).reshape(-1, cfg.d_model)[gone].any()


@pytest.mark.parametrize("arch,cf", CASES)
def test_capacity_matches_jax(arch, cf):
    jcfg, cfg = _cfgs(arch, cf)
    for full in (False, True):
        if full:
            jcfg = dataclasses.replace(jax_get_config(arch),
                                       moe_capacity_factor=cf)
            cfg = dataclasses.replace(get_config(arch),
                                      moe_capacity_factor=cf)
        assert [moe.capacity(cfg, n) for n in range(1, 301)] == \
            [jax_moe.capacity(jcfg, n) for n in range(1, 301)]

