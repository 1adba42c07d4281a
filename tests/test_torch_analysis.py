"""The analysis tools of the port (``roofline``, ``launch/specs``,
``launch/report``, ``launch/hillclimb``, ``layers.weight_quant``,
``tracemode``) against the JAX package's on the same configs and inputs,
and the model's entry points on ``meta`` trees.

The counts are exact: model FLOPs, grad accumulation, the specs' shapes
and dtypes, and the bytes of a collective.  ``dense`` on int8 weights is
held to JAX's within 1e-6 of the largest output in f32 (one dequantising
multiply and a matmul, summed in another order).  What needs a process
group of its own (the fake group, the JAX dry run's import, which sets
``XLA_FLAGS``) runs in a subprocess."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import list_archs as jax_list_archs
from repro_torch import roofline as R
from repro_torch.configs.base import SHAPES, get_config, list_archs, reduced
from repro_torch.launch import specs as S
from repro_torch.models import model as M
from repro_torch.models.layers import tree_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CELLS = [(a, s) for a in list_archs() for s in SHAPES]


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def test_archs_and_shapes_are_the_references():
    assert list_archs() == jax_list_archs()
    assert list(SHAPES) == list(J_SHAPES)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def test_roofline_terms_and_bound_at_h100_rates():
    """As ``tests/test_roofline.py`` does at the TPU's rates."""
    rl = R.Roofline(flops=R.PEAK_BF16, hbm_bytes=R.HBM_BW * 2,
                    coll_bytes=R.LINK_BW / 2, model_flops=R.PEAK_BF16 / 2)
    assert abs(rl.compute_s - 1.0) < 1e-9
    assert abs(rl.memory_s - 2.0) < 1e-9
    assert abs(rl.collective_s - 0.5) < 1e-9
    assert rl.bound == "memory"
    assert abs(rl.step_s - 2.0) < 1e-9
    assert abs(rl.useful_ratio - 0.5) < 1e-9
    assert abs(rl.roofline_fraction - 0.25) < 1e-9
    assert set(rl.as_dict()) >= {"compute_s", "memory_s", "collective_s",
                                 "bound", "step_s", "roofline_fraction"}
    assert (R.PEAK_BF16, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 50e9)


@pytest.mark.parametrize("n_chips", [1, 256, 512])
def test_model_flops_per_chip_equals_jax(n_chips):
    from repro.roofline import model_flops_per_chip as jax_mf
    for arch, shape in CELLS:
        got = R.model_flops_per_chip(get_config(arch), SHAPES[shape],
                                     n_chips)
        want = jax_mf(jax_get_config(arch), J_SHAPES[shape], n_chips)
        assert got == want, (arch, shape)


def test_hbm_traffic_without_a_mesh_equals_jax():
    from repro.roofline import hbm_traffic_model as jax_hbm
    for arch, shape in CELLS:
        assert R.hbm_traffic_model(get_config(arch), SHAPES[shape], None,
                                   {}) == jax_hbm(jax_get_config(arch),
                                                  J_SHAPES[shape], None, {})


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_default_grad_accum_equals_jax(mesh):
    from repro.launch.specs import default_grad_accum as jax_accum
    from repro.sharding import train_rules_for as jax_rules
    from repro_torch.sharding import train_rules_for
    fake = FakeMesh(MESHES[mesh])
    for arch in list_archs():
        got = S.default_grad_accum(get_config(arch), SHAPES["train_4k"],
                                   fake, train_rules_for(get_config(arch)))
        want = jax_accum(jax_get_config(arch), J_SHAPES["train_4k"], fake,
                         jax_rules(jax_get_config(arch)))
        assert got == want, arch


def test_grad_accum_respects_batch_rule():
    """``tests/test_launch.py``'s case, on the port."""
    cfg = get_config("tinyllama-1.1b")
    mesh = FakeMesh(MESHES["16x16"])
    base = S.default_grad_accum(cfg, SHAPES["train_4k"], mesh,
                                {"batch": ("pod", "data")})
    dp = S.default_grad_accum(cfg, SHAPES["train_4k"], mesh,
                              {"batch": ("pod", "data", "model")})
    assert dp <= base and dp == 1


def _leaves(tree) -> list:
    return [(tuple(x.shape), str(x.dtype).split(".")[-1])
            for x in tree_leaves(tree)]


def _jax_leaves(tree) -> list:
    return [(tuple(x.shape), jnp.dtype(x.dtype).name)
            for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_jax(arch, shape):
    """Every cell's inputs as meta tensors: the JAX package's
    ``ShapeDtypeStruct`` trees leaf for leaf, with its long_500k skips."""
    from repro.launch.specs import input_specs as jax_specs
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.supports_long_context:
        pytest.skip("assigned long_500k skip")
    got = S.input_specs(cfg, shape, mesh=None)
    assert all(x.device.type == "meta" for x in tree_leaves(got))
    assert _leaves(got) == _jax_leaves(jax_specs(jax_get_config(arch),
                                                 shape, mesh=None))


def test_input_specs_skip_the_cells_the_reference_skips():
    skipped = [a for a in list_archs()
               if not get_config(a).supports_long_context]
    assert skipped == [a for a in jax_list_archs()
                       if not jax_get_config(a).supports_long_context]
    assert "qwen2-7b" in skipped


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x7b",
                                  "seamless-m4t-medium"])
def test_weight_quant_specs_equal_jax(arch):
    from repro.models import model as JM
    from repro.models.layers import tree_map_specs as jax_map
    from repro.models.layers import weight_quant as jax_quant
    from repro_torch.models.layers import tree_map_specs, weight_quant
    with weight_quant():
        got = []
        tree_map_specs(got.append, M.param_specs(get_config(arch)))
    with jax_quant():
        want = []
        jax_map(want.append, JM.param_specs(jax_get_config(arch)))
    assert [(s.shape, str(s.dtype).split(".")[-1], s.axes) for s in got] \
        == [(s.shape, jnp.dtype(s.dtype).name, s.axes) for s in want]
    assert any(s.dtype == torch.int8 for s in got)
    # outside the context the specs are bf16 again
    assert not any(s.dtype == torch.int8 for s in tree_leaves(
        M.abstract_params(get_config(arch))))


def test_dense_on_int8_weights_equals_jax():
    from repro.models.layers import dense as jax_dense
    from repro_torch.models.layers import dense
    rng = np.random.default_rng(3)
    w = rng.integers(-128, 128, size=(48, 40)).astype(np.int8)
    qs = (rng.random(40) * 0.02).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    got = dense({"w": torch.from_numpy(w), "qscale": torch.from_numpy(qs),
                 "b": torch.from_numpy(b)}, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_dense({"w": jnp.asarray(w),
                                 "qscale": jnp.asarray(qs),
                                 "b": jnp.asarray(b)}, jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_convert_carries_int8_leaves_across():
    from repro_torch.convert import tree_from_numpy
    w = np.arange(-4, 4, dtype=np.int8).reshape(2, 4)
    got = tree_from_numpy({"w": w, "qscale": np.ones(4, np.float32)},
                          device="cpu")
    assert got["w"].dtype == torch.int8
    assert np.array_equal(got["w"].numpy(), w)


# ---------------------------------------------------------------------------
# the entry points on meta trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_entry_points_run_on_meta_trees(arch):
    """decode, prefill and the train forward at full width on
    ``abstract_params``/``abstract_caches``: the kernel wrappers take
    their plain versions on meta tensors, so nothing is built."""
    from repro_torch.kernels import ops
    from repro_torch.tracemode import analysis_mode
    cfg = get_config(arch)
    b, s = 2, 512                  # past qwen2-vl's 256 stub patches
    params = M.abstract_params(cfg)
    caches = M.abstract_caches(cfg, b, 1024)
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.empty(
            (b, cfg.vision_stub_tokens, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
    if cfg.family == "audio":
        batch["frames"] = torch.empty((b, cfg.encoder_src_len, cfg.d_model),
                                      dtype=torch.bfloat16, device="meta")
    with torch.no_grad():
        logits, _ = M.prefill(cfg, params, batch, caches)
        assert logits.shape[0] == b and logits.device.type == "meta"
        logits, _ = M.decode_step(
            cfg, params, torch.empty((b, 1), dtype=torch.int32,
                                     device="meta"),
            torch.empty((b,), dtype=torch.int32, device="meta"), caches)
        assert logits.device.type == "meta"
    with analysis_mode():
        logits = M.forward_train(cfg, params, batch)
    assert tuple(logits.shape[:2]) == (b, s)
    assert ops._EXT is None


def test_analysis_mode_switches_the_chunked_path(monkeypatch):
    """Under ``analysis_mode`` train and prefill take the plain attention
    at any length, as the reference's do."""
    from repro_torch.models import attention as A
    from repro_torch.tracemode import analysis_mode, is_analysis
    calls = []
    monkeypatch.setattr(A, "FLASH_SEQ", 8)
    monkeypatch.setattr(A, "_chunked_attention",
                        lambda *a: calls.append(1) or A._plain_attention(*a))
    cfg = reduced(get_config("qwen2-7b"))
    params = M.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.zeros((1, 16), dtype=torch.int32)}
    with torch.no_grad():
        M.forward_train(cfg, params, batch)
        assert calls
        calls.clear()
        with analysis_mode():
            assert is_analysis()
            M.forward_train(cfg, params, batch)
    assert not calls and not is_analysis()


# ---------------------------------------------------------------------------
# collective bytes (the fake process group, in a process of its own)
# ---------------------------------------------------------------------------

_COLL = r"""
import json
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.roofline import collective_bytes
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
x = DTensor.from_local(torch.zeros(2, 8), mesh, [Shard(0)], run_check=False)
p = DTensor.from_local(torch.zeros(3, 5), mesh, [Partial()], run_check=False)
out = {}
with collective_bytes() as c:
    x.redistribute(mesh, [Replicate()])        # all-gather: (8, 8) f32
out["gather"] = c.summary()
with collective_bytes() as c:
    for _ in range(3):
        p.redistribute(mesh, [Replicate()])    # all-reduce: (3, 5) f32
    dist.all_reduce(torch.zeros(7))            # c10d: 28 bytes
out["loop"] = c.summary()
print(json.dumps(out))
"""


def test_collective_bytes_counts_every_collective():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _COLL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    g = out["gather"]
    assert g["bytes_by_op"]["all-gather"] == 8 * 8 * 4   # result > operand
    assert g["counts"]["all-gather"] == 1 and g["total_bytes"] == 256
    lp = out["loop"]
    assert lp["counts"]["all-reduce"] == 4               # every iteration
    assert lp["bytes_by_op"]["all-reduce"] == 3 * 3 * 5 * 4 + 7 * 4
    assert set(lp["bytes_by_op"]) == {"all-gather", "all-reduce",
                                      "reduce-scatter", "all-to-all",
                                      "collective-permute"}


# ---------------------------------------------------------------------------
# report and hill-climb
# ---------------------------------------------------------------------------


def test_report_later_files_win(tmp_path):
    from repro_torch.launch.report import load
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    a.write_text('{"arch":"x","shape":"s","mesh":"16x16","ok":false}\n')
    b.write_text('{"arch":"x","shape":"s","mesh":"16x16","ok":true}\n')
    assert load([str(a), str(b)])[("x", "s", "16x16")]["ok"] is True


def test_report_renders_a_port_record_at_h100_rates():
    from repro_torch.launch.report import render
    rl = R.Roofline(flops=1e12, hbm_bytes=2e9, coll_bytes=1e8,
                    model_flops=5e11)
    rec = {"arch": "qwen2-7b", "shape": "decode_32k", "mesh": "16x16",
           "ok": True, "fits_hbm": True, "memory": {"peak_bytes": 4e9},
           "collectives": {"bytes_by_op": {"all-gather": 1e8},
                           "counts": {"all-gather": 1}, "total_bytes": 1e8},
           "roofline": rl.as_dict()}
    dr, ro = render({("qwen2-7b", "decode_32k", "16x16"): rec})
    assert "H100" in dr and "85.0 GB/chip" in dr and "| OK | 3.73 |" in dr
    assert "989 TFLOP/s" in ro and "3.35 TB/s" in ro and "50 GB/s" in ro
    assert "TPU" not in dr + ro
    assert f"| {rl.memory_s * 1e3:.2f} |" in ro


_HILL = r"""
import json
from repro.launch.hillclimb import experiments
print(json.dumps([[a, s, {k: (sorted(v.items()) if isinstance(v, dict)
                            else v) for k, v in kw.items()}]
                  for a, s, kw in experiments()]))
"""


def test_hillclimb_experiments_equal_jax():
    from repro_torch.launch.hillclimb import experiments
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _HILL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = [[a, s, {k: (sorted(v.items()) if isinstance(v, dict) else v)
                   for k, v in kw.items()}] for a, s, kw in experiments()]
    assert json.loads(json.dumps(got)) == want
    assert [kw["tag"] for _, _, kw in experiments()][-2:] == \
        ["C0-baseline", "C1-int8-weights"]
