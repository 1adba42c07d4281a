"""The port's dry run (``launch/dryrun.py``) against the JAX package's on
the production meshes.

Three processes of their own, each a module fixture: the JAX package with
512 placeholder host devices (its production meshes, the traffic model
and the specs' shard shapes), the JAX dry run's analysis FLOPs (its import
sets ``XLA_FLAGS``), and the port on torch's fake process group of 256
ranks (the specs' local blocks, and ``run_cell`` on two depth-reduced
cells).  The port's traffic model reads its mesh by axis name, so it
runs here on a stand-in with the production shapes.

Tolerances: the traffic model, the per-chip bytes and the shard shapes
are exact.  The analysis FLOPs are not: ``FlopCounterMode`` counts
matmul-class ops only, while XLA's cost analysis also counts elementwise
ones, so the port counts at most 100 % of XLA's and at least a floor per
cell, set from what it measured: 98 % for every matmul-dominated step
(measured 98.1 % for seamless-m4t-medium's decode, 99.3-99.9 % for the
rest), and 93 % for mamba2-780m's decode step (measured 93.1 %), whose SSM
state update is elementwise work that the counter does not see."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import roofline as R
from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.models import model as M
from repro_torch.sharding import serve_rules_for, train_rules_for

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
SPEC_CELLS = [("qwen2-7b", "decode_32k"), ("tinyllama-1.1b", "train_4k")]
# one config per family, and the train and prefill steps of the dense one
FLOP_CELLS = [("qwen2-7b", "decode_32k"), ("gemma2-9b", "decode_32k"),
              ("mixtral-8x7b", "decode_32k"), ("mamba2-780m", "decode_32k"),
              ("recurrentgemma-2b", "decode_32k"),
              ("qwen2-vl-72b", "decode_32k"),
              ("seamless-m4t-medium", "decode_32k"),
              ("qwen2-7b", "train_4k"), ("qwen2-7b", "prefill_32k")]
FLOP_FLOOR = 0.98
FLOP_FLOORS = {("mamba2-780m", "decode_32k"): 0.93}   # elementwise SSM update


def _run(code: str, *args, env=None) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               **(env or {}))
    res = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _rules(cfg, shape):
    return train_rules_for(cfg) if SHAPES[shape].kind == "train" \
        else serve_rules_for(cfg, shape)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


_JAX = r"""
import json, sys
import jax
from repro.configs.base import SHAPES, get_config, list_archs
from repro.launch.specs import input_specs
from repro.models.model import cache_specs, param_specs
from repro.roofline import hbm_traffic_model, tree_bytes_per_chip
from repro.sharding import serve_rules_for, train_rules_for
meshes = {"16x16": jax.make_mesh((16, 16), ("data", "model")),
          "2x16x16": jax.make_mesh((2, 16, 16), ("pod", "data", "model"))}
out = {"hbm": {}, "bytes": {}, "shards": {}}
for name, mesh in meshes.items():
    for arch in list_archs():
        cfg = get_config(arch)
        for shape, cell in SHAPES.items():
            rules = (train_rules_for(cfg) if cell.kind == "train"
                     else serve_rules_for(cfg, shape))
            key = f"{name}/{arch}/{shape}"
            out["hbm"][key] = hbm_traffic_model(cfg, cell, mesh, rules)
            out["bytes"][key] = [
                tree_bytes_per_chip(param_specs(cfg), mesh, rules),
                tree_bytes_per_chip(cache_specs(cfg, cell.global_batch,
                                                cell.seq_len), mesh, rules)]
for arch, shape in json.loads(sys.argv[1]):
    specs = input_specs(arch, shape, meshes["16x16"])
    out["shards"][f"{arch}/{shape}"] = [
        [list(x.shape), list(x.shape if x.sharding is None
                             else x.sharding.shard_shape(x.shape))]
        for x in jax.tree.leaves(specs)]
print(json.dumps(out))
"""

_JAX_FLOPS = r"""
import json, sys
from repro.launch.dryrun import analysis_flops_bytes
print(json.dumps({f"{a}/{s}": analysis_flops_bytes(a, s, 1)[0]
                  for a, s in json.loads(sys.argv[1])}))
"""

_PORT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs.base import get_config
from repro_torch.launch.dryrun import production_mesh, run_cell
from repro_torch.launch.specs import input_specs
from repro_torch.models.layers import tree_leaves
mesh = production_mesh(multi_pod=False)
out = {"shards": {}, "cells": {}}
for arch, shape in json.loads(sys.argv[1]):
    specs = input_specs(arch, shape, mesh)
    out["shards"][f"{arch}/{shape}"] = [
        [list(x.shape), list((x.to_local() if hasattr(x, "to_local")
                              else x).shape), x.device.type]
        for x in tree_leaves(specs)]
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=2 * len(full.block_pattern))
    out["cells"][f"{arch}/{shape}"] = run_cell(arch, shape, cfg=cfg,
                                               verbose=False)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_run():
    return _run(_JAX, json.dumps(SPEC_CELLS),
                env={"XLA_FLAGS":
                     "--xla_force_host_platform_device_count=512"})


@pytest.fixture(scope="module")
def port_run():
    return _run(_PORT, json.dumps(SPEC_CELLS))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_hbm_traffic_on_the_production_meshes_equals_jax(mesh, jax_run):
    fake = FakeMesh(MESHES[mesh])
    for arch in list_archs():
        cfg = get_config(arch)
        for shape, cell in SHAPES.items():
            key = f"{mesh}/{arch}/{shape}"
            rules = _rules(cfg, shape)
            assert R.hbm_traffic_model(cfg, cell, fake, rules) \
                == jax_run["hbm"][key], key
            assert [R.tree_bytes_per_chip(M.param_specs(cfg), fake, rules),
                    R.tree_bytes_per_chip(M.cache_specs(
                        cfg, cell.global_batch, cell.seq_len), fake, rules)] \
                == jax_run["bytes"][key], key


@pytest.mark.parametrize("arch,shape", SPEC_CELLS)
def test_input_specs_on_the_fake_mesh_hold_the_jax_shard_shapes(
        arch, shape, jax_run, port_run):
    got = port_run["shards"][f"{arch}/{shape}"]
    want = jax_run["shards"][f"{arch}/{shape}"]
    assert [g[:2] for g in got] == want
    assert {g[2] for g in got} == {"meta"}
    assert any(g[0] != g[1] for g in got)      # something is sharded


@pytest.mark.parametrize("arch,shape", SPEC_CELLS)
def test_run_cell_on_the_fake_mesh(arch, shape, port_run):
    """A depth-reduced cell through the whole dry run: it is traced, its
    collectives are counted, its memory fits the card, and the record
    keeps the reference's keys."""
    rec = port_run["cells"][f"{arch}/{shape}"]
    assert rec["ok"], rec.get("error")
    assert rec["mesh"] == "16x16" and rec["fits_hbm"]
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    rl = rec["roofline"]
    assert rl["flops"] > 0 and rl["hbm_bytes"] > 0 and rl["step_s"] > 0
    assert set(rec) >= {"lower_s", "compile_s", "grad_accum",
                        "op_bytes_accessed", "wall_s"}


@pytest.fixture(scope="module")
def jax_flops():
    return _run(_JAX_FLOPS, json.dumps(FLOP_CELLS))


@pytest.mark.parametrize("arch,shape", FLOP_CELLS)
def test_analysis_flops_against_jax(arch, shape, jax_flops):
    from repro_torch.launch.dryrun import analysis_flops_bytes
    got, _ = analysis_flops_bytes(arch, shape, 1)
    ratio = got / jax_flops[f"{arch}/{shape}"]
    assert FLOP_FLOORS.get((arch, shape), FLOP_FLOOR) <= ratio <= 1.0, ratio
