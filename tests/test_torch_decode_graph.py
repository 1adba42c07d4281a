"""Where the port's decode step is replayed from a CUDA graph
(``repro_torch.models.decode_graph``), checked on the CPU: the rule that
decides it, the key that retires a graph, and an engine on the CPU, which
never makes one and gives the JAX engine's ``StepEvent``s event for event
under the fake clock of ``tests/test_torch_recurrent_serving.py``.  The
graph itself runs only on the card: ``squeeze_bench/tests/
test_sqb_decode_graph.py`` holds it to eager steps there."""
import types

import jax
import numpy as np
import pytest
import torch

import repro.serving.engine as jax_engine_mod
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core.arena import ArenaSpec as JaxArenaSpec
from repro.models import model as JM
from repro_torch import spans
from repro_torch.configs.base import get_config, list_archs, reduced
from repro_torch.convert import tree_from_numpy
from repro_torch.core.arena import ArenaSpec
from repro_torch.models import model as M
from repro_torch.models.decode_graph import cache_key, eligible
from repro_torch.models.layers import tree_leaves
from repro_torch.serving.engine import ServeEngine
from repro_torch.sharding import sharding_ctx
from test_torch_recurrent_serving import (JAX_MODULES, TORCH_MODULES,
                                          _fake_time, _trace)

torch.set_num_threads(1)
CUDA = torch.device("cuda")
GRAPHED = ["qwen2-7b", "qwen2-1.5b", "tinyllama-1.1b", "gemma2-9b",
           "mixtral-8x7b", "dbrx-132b", "qwen2-vl-72b"]
EAGER = ["mamba2-780m", "recurrentgemma-2b", "seamless-m4t-medium"]


def test_the_lists_cover_every_architecture():
    assert sorted(GRAPHED + EAGER) == sorted(list_archs())


@pytest.mark.parametrize("arch", GRAPHED)
def test_attention_decoders_are_eligible_on_a_cuda_device(arch):
    assert eligible(get_config(arch), CUDA)
    assert eligible(reduced(get_config(arch)), torch.device("cuda:0"))


@pytest.mark.parametrize("arch", EAGER)
def test_recurrent_and_audio_families_stay_eager(arch):
    """ssm and rglru blocks, and the encoder-decoder family."""
    assert not eligible(get_config(arch), CUDA)


@pytest.mark.parametrize("arch", GRAPHED + EAGER)
def test_nothing_is_eligible_on_the_cpu(arch):
    assert not eligible(get_config(arch), torch.device("cpu"))
    assert not eligible(get_config(arch), "cpu")


def test_nothing_is_eligible_under_a_sharding_context():
    cfg = get_config("qwen2-7b")
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2})
    with sharding_ctx(mesh, {}):
        assert not eligible(cfg, CUDA)
    assert eligible(cfg, CUDA)


def _caches(arch, rows=4):
    return M.init_caches(reduced(get_config(arch)), rows, 16, device="cpu")


KEYED = ["qwen2-7b", "gemma2-9b", "mixtral-8x7b"]


@pytest.mark.parametrize("arch", KEYED)
def test_the_key_changes_when_an_unplug_slices_rows(arch):
    caches = _caches(arch)
    key = cache_key(caches)
    assert key[0] == 4
    sliced = M.cache_slice_rows(caches, 2)
    assert cache_key(sliced) != key and cache_key(sliced)[0] == 2
    # a slice to as many rows is a fresh copy all the same
    assert cache_key(M.cache_slice_rows(caches, 4)) != key


@pytest.mark.parametrize("arch", KEYED)
def test_the_key_changes_when_a_plug_grows_rows(arch):
    caches = _caches(arch)
    grown = M.cache_grow_rows(caches, 8)
    assert cache_key(grown) != cache_key(caches)
    assert cache_key(grown)[0] == 8


@pytest.mark.parametrize("arch", KEYED)
def test_row_writes_keep_the_key(arch):
    """A cold start's ``cache_write_row`` and a restore's
    ``cache_write_rows`` write in place: the graph stays valid."""
    cfg = reduced(get_config(arch))
    caches = _caches(arch)
    key = cache_key(caches)
    row = M.init_caches(cfg, 1, 16, device="cpu")
    for x in tree_leaves(row):
        x.fill_(1.5)
    assert cache_key(M.cache_write_row(caches, row, 2)) == key
    blob = M.cache_read_rows(caches, [2])
    assert cache_key(M.cache_write_rows(caches, blob.repeat(2, 1),
                                        [1, 3])) == key
    assert all(bool((x.narrow(0 if x.dim() == 4 else 1, 3, 1) == 1.5).all())
               for x in tree_leaves(caches))


@pytest.fixture(scope="module")
def qwen2():
    jcfg = jax_reduced(jax_get_config("qwen2-7b"))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen2-7b"))
    params = tree_from_numpy(jax.device_get(jparams), "cpu")
    return (cfg, params, ArenaSpec.from_model(cfg, 128, 8, 32),
            jcfg, jparams, JaxArenaSpec.from_model(jcfg, 128, 8, 32))


def test_a_cpu_engine_steps_eagerly_as_before(qwen2, monkeypatch):
    """Up the ladder and back down on the CPU: the engine's
    ``DecodeGraph`` runs every step eagerly and makes no graph, every
    ``decode.dispatch`` span says ``eager``, and the ``StepEvent``s (kinds,
    order, times, details, reclaimed bytes) and the arena's cache bytes
    are the JAX engine's."""
    cfg, params, spec, jcfg, jparams, jspec = qwen2
    _fake_time(monkeypatch, JAX_MODULES)
    want = jax_engine_mod.ServeEngine(jcfg, jparams, jspec, mode="hotmem",
                                      keep_alive=3.0)
    want.run(_trace("jax"), max_virtual_s=2000)
    _fake_time(monkeypatch, TORCH_MODULES)
    eng = ServeEngine(cfg, params, spec, mode="hotmem", keep_alive=3.0)
    spans.clear()
    spans.enable()
    try:
        m = eng.run(_trace("torch"), max_virtual_s=2000)
    finally:
        spans.enable(False)
    modes = [r.attrs["graph"] for r in spans.log()
             if r.name == "decode.dispatch"]
    spans.clear()
    assert eng._graph.graph is None and eng._graph.key is None
    assert eng.graph_captures == eng.graph_replays == 0
    assert modes == ["eager"] * m["decode_steps"] and modes
    assert [(e.t, e.kind, e.wall_s, e.detail) for e in eng.events] == \
        [(e.t, e.kind, e.wall_s, e.detail) for e in want.events]
    assert [(tuple(x.shape), x.nbytes) for x in tree_leaves(eng.caches)] \
        == [(tuple(x.shape), np.asarray(x).nbytes)
            for x in jax.tree.leaves(want.caches)]
