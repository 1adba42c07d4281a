"""The port's layer functions (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``) on the same inputs, made with numpy from
a seed.  Everything runs in f32 on the CPU, tolerance 2e-5 (the repo's f32
kernel tolerance): the same arithmetic, summed in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import list_archs, reduced as jax_reduced
from repro.models import layers as JL
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import layers as L

torch.set_num_threads(1)
TOL = 2e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    x, w, b = _x((2, 5, 16)), _x((16, 24), 1), _x((24,), 2)
    pj = {"w": jnp.asarray(w)}
    pt = {"w": torch.from_numpy(w)}
    if bias:
        pj["b"], pt["b"] = jnp.asarray(b), torch.from_numpy(b)
    _close(L.dense(pt, torch.from_numpy(x)), JL.dense(pj, jnp.asarray(x)))


def test_rmsnorm():
    x, s = _x((2, 5, 32), 3, 4.0), _x((32,), 4)
    _close(L.rmsnorm({"scale": torch.from_numpy(s)}, torch.from_numpy(x),
                     1e-6),
           JL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_act_fn(name):
    x = _x((4, 33), 5, 3.0)
    _close(L.act_fn(name, torch.from_numpy(x)), JL.act_fn(name,
                                                          jnp.asarray(x)))


def test_mlp():
    cfg = reduced(get_config("qwen2-7b"))
    ws = {k: _x(s, i) for i, (k, s) in enumerate(
        [("gate", (cfg.d_model, cfg.d_ff)), ("up", (cfg.d_model, cfg.d_ff)),
         ("down", (cfg.d_ff, cfg.d_model))])}
    x = _x((2, 3, cfg.d_model), 9)
    pt = {k: {"w": torch.from_numpy(w)} for k, w in ws.items()}
    pj = {k: {"w": jnp.asarray(w)} for k, w in ws.items()}
    _close(L.mlp(cfg, pt, torch.from_numpy(x)),
           JL.mlp(jax_reduced(jax_get_config("qwen2-7b")), pj,
                  jnp.asarray(x)))


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_softcap(cap):
    x = _x((3, 17), 6, 50.0)
    _close(L.softcap(torch.from_numpy(x), cap), JL.softcap(jnp.asarray(x),
                                                           cap))


@pytest.mark.parametrize("sections", [(), (4, 2, 2)])
def test_apply_rope(sections):
    x = _x((2, 7, 3, 16), 7)
    rng = np.random.default_rng(8)
    shape = (3, 2, 7) if sections else (2, 7)
    pos = rng.integers(0, 5000, size=shape).astype(np.int32)
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                        sections),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections))


@pytest.mark.parametrize("arch", list_archs())
def test_padded_vocab(arch):
    assert L.padded_vocab(get_config(arch)) == \
        JL.padded_vocab(jax_get_config(arch))


def test_tree_flatten_order_matches_jax():
    tree = {"z": (1, {"b": 2, "a": 3}), "a": {"y": [4, 5], "c": 6},
            "m": ()}
    leaves, treedef = L.tree_flatten(tree)
    assert leaves == jax.tree.flatten(tree)[0]
    assert L.tree_unflatten(treedef, leaves) == tree
    assert L.tree_map(lambda v: v * 10, tree)["z"][1]["a"] == 30


def test_stack_specs_matches_jax():
    def shapes(tree, mod):
        out = []
        mod.tree_map_specs(lambda s: out.append((s.shape, s.axes)), tree)
        return out
    t = L.stack_specs(L.mlp_spec(reduced(get_config("qwen2-7b"))), 3)
    j = JL.stack_specs(JL.mlp_spec(jax_reduced(jax_get_config("qwen2-7b"))),
                       3)
    assert shapes(t, L) == shapes(j, JL)


def test_materialize_fan_in_rule_and_seed():
    specs = {"w": L.ParamSpec((512, 256)), "e": L.ParamSpec((64, 32),
                                                           scale=24.0),
             "z": L.ParamSpec((8,), L.f32, init="zeros"),
             "o": L.ParamSpec((8,), L.f32, init="ones")}
    a = L.materialize(specs, 0, device="cpu")
    b = L.materialize(specs, 0, device="cpu")
    c = L.materialize(specs, 1, device="cpu")
    assert a["w"].dtype == torch.bfloat16 and a["z"].dtype == torch.float32
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])
    # std = scale / sqrt(fan_in), fan_in = shape[-2] (layers.py rule)
    assert abs(float(a["w"].float().std()) - 512 ** -0.5) < 0.05 * 512 ** -.5
    assert abs(float(a["e"].float().std()) - 24.0 / 8) < 0.1 * 3.0
    assert not a["z"].any() and bool((a["o"] == 1).all())

