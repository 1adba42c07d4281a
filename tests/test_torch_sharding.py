"""The port's rule engine (``repro_torch.sharding``) against the JAX
package's (``repro.sharding``): the rule tables value for value,
``serve_rules_for`` and ``train_rules_for`` for every config and shape,
``spec_for`` on every parameter and cache leaf of every config under both
production mesh shapes and both rule kinds, the shard shapes that the
port's DTensor placements give against the ones JAX's specs imply, and
twins of ``tests/test_sharding.py``.  The production meshes themselves
are built under torch's fake process group at 256 and 512 ranks, in a
subprocess (the fake group is process-wide).  No tolerance: everything
here is exact."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import sharding as JS
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro.models.layers import ParamSpec as JParamSpec
from repro_torch import sharding as S
from repro_torch.configs.base import get_config, list_archs
from repro_torch.models import model as M
from repro_torch.models.layers import ParamSpec, tree_leaves

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = list_archs()
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _ctx(shape=None, rules=S.TRAIN_RULES):
    return S.ShardCtx(FakeMesh(shape or {"data": 16, "model": 16}), rules)


def _jax_leaves(tree):
    out = []

    def walk(t):
        if isinstance(t, JParamSpec):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            for v in t:
                walk(v)
    walk(tree)
    return out


def _leaf_pairs(arch):
    """(port ParamSpec, JAX ParamSpec) for every param leaf, then every
    cache leaf at batch 128, 32768 tokens."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    port = tree_leaves(M.param_specs(cfg)) \
        + tree_leaves(M.cache_specs(cfg, 128, 32768))
    ref = _jax_leaves(JM.param_specs(jcfg)) \
        + _jax_leaves(JM.cache_specs(jcfg, 128, 32768))
    assert len(port) == len(ref)
    for p, j in zip(port, ref):
        assert isinstance(p, ParamSpec)
        assert (p.shape, p.axes) == (j.shape, j.axes)
    return [(p.axes, p.shape) for p in port]


def _rules(kind, arch):
    if kind == "train":
        return (S.train_rules_for(get_config(arch)),
                JS.train_rules_for(jax_get_config(arch)))
    return (S.serve_rules_for(get_config(arch), "decode_32k"),
            JS.serve_rules_for(jax_get_config(arch), "decode_32k"))


@pytest.mark.parametrize("name", ["TRAIN_RULES", "SERVE_RULES",
                                  "SERVE_BIG_RULES", "SERVE_CP_RULES",
                                  "DP_ONLY_TRAIN_RULES", "PAD_OK",
                                  "_DP_ONLY_MAX_BYTES"])
def test_rule_tables_equal_jax(name):
    assert getattr(S, name) == getattr(JS, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_for_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape in JSHAPES:
        assert S.serve_rules_for(cfg, shape) == JS.serve_rules_for(jcfg,
                                                                   shape)
    for dp_only in (None, True, False):
        assert S.train_rules_for(cfg, dp_only=dp_only) \
            == JS.train_rules_for(jcfg, dp_only=dp_only)


@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_equals_jax_on_every_leaf(arch, mesh, kind):
    rules, jrules = _rules(kind, arch)
    ctx = S.ShardCtx(FakeMesh(MESHES[mesh]), rules)
    jctx = JS.ShardCtx(FakeMesh(MESHES[mesh]), jrules)
    for axes, shape in _leaf_pairs(arch):
        got, want = S.spec_for(axes, shape, ctx), JS.spec_for(axes, shape,
                                                              jctx)
        assert tuple(got) == tuple(want), (axes, shape)
        # the block each device holds: the port's record against the
        # shape the JAX spec implies
        implied = tuple(
            d // math.prod(MESHES[mesh][a] for a in (
                () if e is None else (e,) if isinstance(e, str) else e))
            for d, e in zip(shape, tuple(want)))
        assert S.NamedSharding(FakeMesh(MESHES[mesh]), got).shard_shape(
            shape) == implied


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_placements_follow_the_mesh_order(mesh):
    from torch.distributed.tensor import Replicate, Shard
    fm = FakeMesh(MESHES[mesh])
    pod = "pod" in MESHES[mesh]
    spec = S.P(("pod", "data") if pod else "data", None, "model")
    assert S.placements(spec, fm) == ((Shard(0),) if pod else ()) \
        + (Shard(0), Shard(2))
    assert S.placements(S.P(None, None), fm) == (Replicate(),) * len(
        MESHES[mesh])
    with pytest.raises(ValueError, match="mesh's order"):
        S.placements(S.P(("model", "data")), fm)


def test_shard_without_a_context_is_the_identity():
    x = torch.ones(4, 4)
    assert S.shard(x, "batch", "embed") is x
    with S.sharding_ctx(FakeMesh({"data": 2}), S.TRAIN_RULES):
        assert S.current_ctx() is not None
        assert S.shard(x, "batch", "embed") is x     # a plain tensor
    assert S.current_ctx() is None


def test_mesh_topology_counts_the_mesh():
    topo = S.mesh_topology(FakeMesh({"pod": 2, "data": 16, "model": 16}),
                           8)
    assert topo.n_devices == 512 and topo.budgets[0] == 8


# -- twins of tests/test_sharding.py -------------------------------------


def test_even_division_shards():
    spec = S.spec_for(("batch", "seq", "embed"), (256, 4096, 1024), _ctx())
    assert spec == S.P("data", None, None)     # no 'pod' in mesh


def test_uneven_head_count_replicates():
    spec = S.spec_for(("batch", "seq", "heads", None), (256, 128, 28, 128),
                      _ctx())
    assert spec[2] is None


def test_multi_axis_prefix_fallback():
    ctx = _ctx({"pod": 2, "data": 16, "model": 16})
    assert S.spec_for(("batch",), (32,), ctx) == S.P(("pod", "data"))
    assert S.spec_for(("batch",), (2,), ctx) == S.P("pod")
    assert S.spec_for(("batch",), (1,), ctx) == S.P(None)


def test_axis_used_once_per_tensor():
    ctx = _ctx(rules=dict(S.TRAIN_RULES, embed=("data",)))
    spec = S.spec_for(("batch", "seq", "embed"), (256, 128, 1024), ctx)
    assert spec == S.P("data", None, None)


def test_serve_rules_shard_kv_seq_not_heads():
    spec = S.spec_for(("batch", "kv_seq", "kv_heads", None),
                      (128, 32768, 8, 128), _ctx(rules=S.SERVE_RULES))
    assert spec == S.P("data", "model", None, None)


def test_big_model_gets_2d_weights():
    big = S.serve_rules_for(get_config("qwen2-vl-72b"), "decode_32k")
    small = S.serve_rules_for(get_config("qwen2-7b"), "decode_32k")
    assert big["w_embed"] == ("pod", "data")
    assert small["w_embed"] is None


def test_long_context_rules_use_cp():
    rules = S.serve_rules_for(get_config("mamba2-780m"), "long_500k")
    assert rules["kv_seq"] == ("data", "model")
    assert rules["batch"] is None


def test_moe_tp_rules():
    rules = S.train_rules_for(get_config("mixtral-8x7b"))
    assert rules["experts"] is None
    assert rules["expert_mlp"] == "model"
    rules_ep = S.train_rules_for(get_config("dbrx-132b"))
    assert rules_ep["experts"] == "model"


def test_partition_spec_compares_as_jax_does():
    assert tuple(S.P("data", ("pod", "model"), None)) \
        == tuple(JP("data", ("pod", "model"), None))


# -- production meshes under the fake process group ----------------------

_FAKE = r"""
import json, math, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from repro_torch import sharding as S
from repro_torch.configs.base import get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves

multi = sys.argv[1] == "1"
RANKS = json.loads(sys.argv[2])
world = 512 if multi else 256
out = {"leaves": [], "offsets": {}}
for rank in [r for r in RANKS if r < world]:
    # the same mesh seen from each of these ranks: DTensor's own
    # local-shape and offset utility over the port's placements
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    out["names"], out["shape"] = list(mesh.mesh_dim_names), list(mesh.shape)
    out["offsets"][rank] = offsets = []
    for arch in list_archs():
        cfg = get_config(arch)
        specs = tree_leaves(M.param_specs(cfg)) \
            + tree_leaves(M.cache_specs(cfg, 128, 32768))
        for rules in (S.train_rules_for(cfg),
                      S.serve_rules_for(cfg, "decode_32k")):
            for s in specs:
                sh = S.named_sharding(s.axes, s.shape, mesh, rules)
                local, offset = compute_local_shape_and_global_offset(
                    s.shape, mesh, sh.placements)
                offsets.append(list(offset))
                if rank == 0:
                    out["leaves"].append([arch, list(s.axes),
                                          list(s.shape), list(local)])
    if rank != 0:
        dist.destroy_process_group()
try:
    make_production_mesh(multi_pod=not multi, device_type="cpu")
except ValueError as e:
    out["refused"] = str(e)
print(json.dumps(out))
"""


# the first and last ranks, their neighbours on the minor axes, and the
# first rank of the second pod
OFFSET_RANKS = [1, 16, 255, 256, 511, 0]


@pytest.fixture(scope="module", params=[False, True], ids=["16x16",
                                                            "2x16x16"])
def fake_mesh_run(request):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _FAKE,
                          "1" if request.param else "0",
                          json.dumps(OFFSET_RANKS)], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return request.param, json.loads(res.stdout.strip().splitlines()[-1])


def test_make_production_mesh_under_a_fake_group(fake_mesh_run):
    multi, out = fake_mesh_run
    assert out["names"] == (["pod", "data", "model"] if multi
                            else ["data", "model"])
    assert out["shape"] == ([2, 16, 16] if multi else [16, 16])
    assert "needs" in out["refused"]      # the other shape: wrong world


def test_dtensor_local_shapes_equal_the_jax_shard_shapes(fake_mesh_run):
    """Rank 0's block, from DTensor's own local-shape utility over the
    port's placements, against the shape JAX's spec implies for that
    leaf under the same mesh and rules."""
    multi, out = fake_mesh_run
    mesh = FakeMesh(MESHES["2x16x16" if multi else "16x16"])
    seen = 0
    for arch in ARCHS:
        jcfg = jax_get_config(arch)
        leaves = [(tuple(a), tuple(s), tuple(loc)) for x, a, s, loc
                  in out["leaves"] if x == arch]
        n = len(leaves) // 2
        for jrules, part in ((JS.train_rules_for(jcfg), leaves[:n]),
                             (JS.serve_rules_for(jcfg, "decode_32k"),
                              leaves[n:])):
            jctx = JS.ShardCtx(mesh, jrules)
            for axes, shape, local in part:
                spec = JS.spec_for(axes, shape, jctx)
                implied = tuple(
                    d // math.prod(mesh.shape[a] for a in (
                        () if e is None else (e,) if isinstance(e, str)
                        else e)) for d, e in zip(shape, tuple(spec)))
                assert local == implied, (arch, axes, shape)
                seen += 1
    assert seen == len(out["leaves"])


def _jax_leaf_specs(out, mesh):
    """JAX's spec of every leaf of ``out["leaves"]``, in their order."""
    specs = []
    for arch in ARCHS:
        jcfg = jax_get_config(arch)
        leaves = [(tuple(a), tuple(s)) for x, a, s, _ in out["leaves"]
                  if x == arch]
        n = len(leaves) // 2
        for jrules, part in ((JS.train_rules_for(jcfg), leaves[:n]),
                             (JS.serve_rules_for(jcfg, "decode_32k"),
                              leaves[n:])):
            jctx = JS.ShardCtx(mesh, jrules)
            specs += [(shape, JS.spec_for(axes, shape, jctx))
                      for axes, shape in part]
    return specs


def test_dtensor_blocks_are_the_jax_blocks(fake_mesh_run):
    """The block each rank holds, from DTensor's offsets over the port's
    placements, is the block JAX's spec gives it: a dim split over
    several mesh axes is cut major to minor, in the spec's order (the
    shard index along ("pod", "data") is pod * 16 + data).  Ranks 1, 16,
    255, 256 and 511 move along each mesh axis; the leaves are every
    param and cache leaf of every arch under both rule kinds."""
    multi, out = fake_mesh_run
    mesh = FakeMesh(MESHES["2x16x16" if multi else "16x16"])
    sizes = list(mesh.shape.values())
    specs = _jax_leaf_specs(out, mesh)
    multi_axis = 0
    for rank, offsets in out["offsets"].items():
        coord = dict(zip(mesh.shape, np.unravel_index(int(rank), sizes)))
        assert len(offsets) == len(specs)
        for (shape, spec), offset in zip(specs, offsets):
            want = []
            for d, e in zip(shape, tuple(spec) + (None,) * len(shape)):
                axes = () if e is None else (e,) if isinstance(e, str) \
                    else tuple(e)
                multi_axis += len(axes) > 1
                index, n = 0, 1
                for a in axes:                       # major to minor
                    index, n = index * mesh.shape[a] + int(coord[a]), \
                        n * mesh.shape[a]
                want.append(index * (d // n))
            assert tuple(offset) == tuple(want), (rank, shape, spec)
    assert multi_axis > 0                  # dims over two or three axes
    assert set(out["offsets"]) == {str(r) for r in OFFSET_RANKS
                                   if r < (512 if multi else 256)}
