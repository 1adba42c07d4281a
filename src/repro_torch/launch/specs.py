"""Zero-allocation stand-ins for every (architecture x shape) cell's inputs.

Port of ``repro.launch.specs``.  ``input_specs`` returns ``meta`` tensors
(the twin of ``jax.ShapeDtypeStruct``), and on a mesh meta DTensors of the
global shape whose local blocks carry the shard shapes, for the step each
cell traces:

  * train_4k          -> train_step(state, batch)
  * prefill_32k       -> prefill(params, batch, caches)
  * decode_32k/500k   -> decode_step(params, tokens, positions, caches)

Modality frontends are stubs: VLM cells carry precomputed patch
embeddings, audio cells precomputed frame embeddings.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeCell
from repro_torch.models import model as M
from repro_torch.models.layers import ParamSpec, bf16, materialize, tree_map
from repro_torch.sharding import Rules, is_dtensor, mesh_shape

i32 = torch.int32

# saved-boundary activation budget per chip for remat'd train cells
_SAVED_ACT_BUDGET = 2 * 2 ** 30


def _sds(shape, dtype, axes, mesh, rules):
    return materialize(ParamSpec(tuple(shape), dtype, axes), abstract=True,
                       mesh=mesh, rules=rules)


def scan_boundaries(cfg: ModelConfig) -> int:
    if cfg.family == "audio":
        return cfg.num_layers + cfg.encoder_layers
    return cfg.n_groups


def default_grad_accum(cfg: ModelConfig, cell: ShapeCell, mesh,
                       rules=None) -> int:
    """Pick grad-accum so saved scan boundaries fit the activation budget.
    Every extra accum step re-pays the per-microbatch FSDP weight gathers,
    so when seq_remat shards the saved boundaries over "model" the budget
    stretches 16x and accum (hence gather traffic) drops accordingly."""
    shape = mesh_shape(mesh) if mesh is not None else {}
    batch_axes = ("pod", "data")
    if rules is not None and rules.get("batch") is not None:
        b = rules["batch"]
        batch_axes = (b,) if isinstance(b, str) else tuple(b)
    batch_shards = math.prod(shape.get(a, 1) for a in batch_axes)
    per_dev = max(cell.global_batch // batch_shards, 1)
    per_mb_bytes = scan_boundaries(cfg) * cell.seq_len * cfg.d_model * 2
    if rules is not None and rules.get("seq_remat") and mesh is not None:
        ax = rules["seq_remat"]
        per_mb_bytes //= math.prod(
            shape.get(a, 1) for a in ((ax,) if isinstance(ax, str) else ax))
    if cfg.family in ("ssm", "hybrid"):
        # recurrence backward passes materialize fp32 coefficient arrays
        per_mb_bytes *= 4
    mb_max = max(int(_SAVED_ACT_BUDGET // per_mb_bytes), 1)
    accum = max(1, -(-per_dev // mb_max))
    while per_dev % accum and accum < per_dev:
        accum += 1
    return min(accum, per_dev)


def _f32_like(x: torch.Tensor) -> torch.Tensor:
    """A meta tensor (or meta DTensor, same placements) like ``x`` in f32."""
    if not is_dtensor(x):
        return torch.empty(x.shape, dtype=torch.float32, device="meta")
    from torch.distributed.tensor import DTensor
    local = torch.empty(x.to_local().shape, dtype=torch.float32,
                        device="meta")
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def train_state_specs(cfg: ModelConfig, mesh, rules):
    params = M.abstract_params(cfg, mesh=mesh, rules=rules)
    return {
        "params": params,
        "opt": {
            "step": torch.empty((), dtype=i32, device="meta"),
            "master": tree_map(_f32_like, params),
            "m": tree_map(_f32_like, params),
            "v": tree_map(_f32_like, params),
        },
    }


def batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh, rules,
                labels: bool):
    b, s = cell.global_batch, cell.seq_len
    out: dict[str, Any] = {
        "tokens": _sds((b, s), i32, ("batch", "seq"), mesh, rules)}
    if labels:
        out["labels"] = _sds((b, s), i32, ("batch", "seq"), mesh, rules)
    if cfg.family == "vlm":
        out["vision_embeds"] = _sds(
            (b, cfg.vision_stub_tokens, cfg.d_model), bf16,
            ("batch", None, "embed"), mesh, rules)
    if cfg.family == "audio":
        out["frames"] = _sds((b, cfg.encoder_src_len, cfg.d_model), bf16,
                             ("batch", "src", "embed"), mesh, rules)
    return out


def input_specs(arch_or_cfg, shape_name: str, mesh=None,
                rules: Rules | None = None) -> dict[str, Any]:
    """All inputs for one cell's step function, as meta (DTensor) trees."""
    from repro_torch.configs.base import get_config
    from repro_torch.sharding import serve_rules_for, train_rules_for
    cfg = arch_or_cfg if isinstance(arch_or_cfg, ModelConfig) else \
        get_config(arch_or_cfg)
    cell = SHAPES[shape_name]
    if rules is None and mesh is not None:
        rules = (train_rules_for(cfg) if cell.kind == "train"
                 else serve_rules_for(cfg, shape_name))

    if cell.kind == "train":
        return {
            "state": train_state_specs(cfg, mesh, rules),
            "batch": batch_specs(cfg, cell, mesh, rules, labels=True),
        }

    b = cell.global_batch
    caches = M.abstract_caches(cfg, b, cell.seq_len, mesh=mesh, rules=rules)
    params = M.abstract_params(cfg, mesh=mesh, rules=rules)
    if cell.kind == "prefill":
        return {
            "params": params,
            "batch": batch_specs(cfg, cell, mesh, rules, labels=False),
            "caches": caches,
        }
    # decode: one new token against a seq_len-deep cache
    return {
        "params": params,
        "tokens": _sds((b, 1), i32, ("batch", None), mesh, rules),
        "positions": _sds((b,), i32, ("batch",), mesh, rules),
        "caches": caches,
    }
