"""Roofline analysis of the port's steps, at the rates of one NVIDIA H100
SXM (80 GB HBM3), the card the port targets.

Port of ``repro.roofline``.  Three terms per (arch x shape x mesh) cell:

    compute    = FLOPs  / PEAK_BF16           (per-chip step)
    memory     = HBM bytes / HBM_BW
    collective = collective bytes / LINK_BW

Torch has no lowered module to read, so each reading has a torch
counterpart taken from one eager run of the step on ``meta`` tensors
(shapes only; nothing is computed or allocated):

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (``cost_analysis``);
    it counts matmul-class ops, where XLA's cost analysis also counts
    elementwise ones;
  * collective bytes: ``collective_bytes``, a dispatch mode that sees each
    collective DTensor (or the model's own ``torch.distributed`` calls)
    issues, at max(result bytes, operand bytes) as the reference's HLO
    parse counts them.  Loops run eagerly, so every iteration is seen:
    the counterpart of multiplying while bodies by their trip counts;
  * HBM bytes: ``hbm_traffic_model``, the reference's model of per-chip
    traffic from the sharded spec trees, value for value.

Rates (NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates
without sparsity, as tabulated in the Hopper architecture white paper):
989 TFLOP/s bf16 and 3.35 TB/s HBM3, both at the full 700 W power limit
(a card set lower runs slower, so every measurement states its limit).
``LINK_BW`` is 50 GB/s per GPU: the 400 Gb/s ConnectX-7 InfiniBand port
each H100 of a DGX H100 has (DGX H100 user guide).  A 16-wide "model"
axis spans two 8-GPU nodes, so its collectives cross that network, not
only NVLink's 450 GB/s a direction; one constant, as the reference has
one for its ICI link.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.sharding import mesh_shape

HBM_BW = 3.35e12            # bytes/s, device memory
PEAK_BF16 = 989e12          # FLOP/s, bf16 tensor cores (dense)
LINK_BW = 50e9              # bytes/s per GPU, one 400 Gb/s NIC


def bound_seconds(nbytes: float, flops: float = 0.0,
                  peak: float = PEAK_BF16) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over ``peak``.  Returns (seconds, "bytes" or
    "operations")."""
    mem, ops = nbytes / HBM_BW, flops / peak
    return (mem, "bytes") if mem >= ops else (ops, "operations")


# ---------------------------------------------------------------------------
# Collective bytes
# ---------------------------------------------------------------------------

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# op name (the overload packet's) -> the reference's collective name.
# Functional ops (``_c10d_functional``, what DTensor issues) take their
# input first and return the result; the in-place ``c10d`` ops (what
# ``torch.distributed.all_reduce`` and friends issue) take the output
# first and the input second.
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_INPLACE = {
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(x) for x in tree)
    return 0


def _collective(func, args, out) -> tuple[str, int] | None:
    """(collective name, bytes) for a collective op, else None."""
    ns = func.namespace
    name = func._overloadpacket.__name__
    if ns in ("_c10d_functional", "c10d_functional") and name in _FUNCTIONAL:
        return _FUNCTIONAL[name], max(_nbytes(out), _nbytes(args[0]))
    if ns == "_dtensor" and name == "shard_dim_alltoall":
        return "all-to-all", max(_nbytes(out), _nbytes(args[0]))
    if ns == "c10d" and name in _INPLACE:
        res = _nbytes(args[0])
        ops = _nbytes(args[1]) if name not in (
            "allreduce_", "allreduce_coalesced_", "send") else res
        return _INPLACE[name], max(res, ops)
    return None


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


class collective_bytes(TorchDispatchMode):
    """Per-collective byte totals of the ops run under it:

        with collective_bytes() as coll:
            step(...)
        coll.summary()  # {"bytes_by_op", "counts", "total_bytes"}

    keyed by the reference's op names.  Each op counts max(result bytes,
    operand bytes) of the rank's local tensors: the traffic a chip puts on
    its links for it (an all-gather's result is larger than its operand, a
    reduce-scatter's the reverse).  Ops on DTensors are let through, so
    the mode sees the collectives they become."""

    def __init__(self):
        super().__init__()
        self.bytes_by_op = {c: 0.0 for c in _COLLECTIVES}
        self.counts = {c: 0.0 for c in _COLLECTIVES}
        self._dtensor = _dtensor_type()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        got = _collective(func, args, out)
        if got is not None:
            self.bytes_by_op[got[0]] += got[1]
            self.counts[got[0]] += 1
        return out

    def summary(self) -> dict[str, Any]:
        return {"bytes_by_op": dict(self.bytes_by_op),
                "counts": dict(self.counts),
                "total_bytes": sum(self.bytes_by_op.values())}


# ---------------------------------------------------------------------------
# FLOPs and bytes accessed
# ---------------------------------------------------------------------------


class _OpBytes(TorchDispatchMode):
    """Sum of every dispatched op's input and output bytes: what XLA's
    unoptimised "bytes accessed" counts (every pre-fusion intermediate).
    Kept for reference only, as the reference keeps its reading."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.total += _nbytes(list(args) + list(kwargs.values())) \
            + _nbytes(out)
        return out


@contextlib.contextmanager
def cost_analysis():
    """Count the FLOPs (``FlopCounterMode``) and the op bytes (``_OpBytes``)
    of the ops run inside; yields a dict that holds ``flops`` and ``bytes
    accessed`` on exit, the keys of XLA's ``cost_analysis()``."""
    from torch.utils.flop_counter import FlopCounterMode
    cost: dict[str, float] = {}
    fc, ob = FlopCounterMode(display=False), _OpBytes()
    with fc, ob:
        yield cost
    cost["flops"] = float(fc.get_total_flops())
    cost["bytes accessed"] = float(ob.total)


def cost_flops_bytes(cost: Any) -> tuple[float, float]:
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost.get("flops", 0.0)), \
        float(cost.get("bytes accessed", 0.0))


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-chip step FLOPs
    hbm_bytes: float             # per-chip HBM bytes
    coll_bytes: float            # per-chip collective bytes
    model_flops: float           # useful-math flops per chip (6ND etc.)

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_BF16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step-time lower bound = max of the three terms (perfect
        overlap assumption)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the bound:
        (useful flops / peak) / step_time."""
        ideal = self.model_flops / PEAK_BF16
        return ideal / self.step_s if self.step_s else 0.0

    def as_dict(self) -> dict[str, Any]:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bound": self.bound,
            "step_s": self.step_s, "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_per_chip(cfg, cell, n_chips: int, grad_accum: int = 1) -> \
        float:
    """6*N*D (train) / 2*N*D (inference) useful-math floor, active params
    for MoE, divided across chips."""
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        total = 6.0 * n_active * tokens
    elif cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per row
        total = 2.0 * n_active * cell.global_batch
    return total / n_chips


# ---------------------------------------------------------------------------
# HBM traffic model (memory roofline term), the reference's:
#
#   decode :  weights (read once) + full live cache read + O(1) cache
#             write + the logits.
#   prefill:  weights + cache write + ACT_RW residual-sized activation
#             reads/writes per layer (a heuristic; prefill is
#             compute-bound, so the bound is insensitive to ACT_RW).
#   train  :  3x weight reads (fwd, remat recompute, bwd; FSDP gathers
#             re-materialise the full per-layer weights on every chip) +
#             grad write/read + fp32 m/v/master read+write + 2x saved
#             group boundaries + 3x activation traffic.
# ---------------------------------------------------------------------------

ACT_RW = 12          # residual-stream-sized tensor r/w per layer per pass


def tree_bytes_per_chip(spec_tree, mesh, rules) -> int:
    """Actual per-chip bytes of a ParamSpec tree under its shardings."""
    from repro_torch.models.layers import tree_map_specs
    from repro_torch.sharding import named_sharding
    total = 0

    def acc(s):
        nonlocal total
        if mesh is None:
            shard = s.shape
        else:
            shard = named_sharding(s.axes, s.shape, mesh, rules)\
                .shard_shape(s.shape)
        total += math.prod(shard) * s.dtype.itemsize

    tree_map_specs(acc, spec_tree)
    return total


def _axes_product(mesh, axes) -> int:
    if mesh is None:
        return 1
    shape = mesh_shape(mesh)
    return math.prod(shape.get(a, 1) for a in axes)


def _rule_axes(rules, name: str, default: tuple[str, ...]):
    if rules and rules.get(name) is not None:
        r = rules[name]
        return (r,) if isinstance(r, str) else tuple(r)
    return default


def hbm_traffic_model(cfg, cell, mesh, rules, grad_accum: int = 1) -> float:
    """Per-chip HBM bytes per step (see block comment above)."""
    from repro_torch.launch.specs import scan_boundaries
    from repro_torch.models.model import cache_specs, param_specs
    p_shard = tree_bytes_per_chip(param_specs(cfg), mesh, rules)
    n_layers = cfg.num_layers + cfg.encoder_layers
    batch_shards = _axes_product(mesh, _rule_axes(rules, "batch",
                                                  ("pod", "data")))
    # weight reads re-materialise at the FSDP-gathered size: the stored
    # shard times the product of the gathered (w_embed) axes
    gather_x = _axes_product(mesh, _rule_axes(rules, "w_embed", ()))

    if cell.kind == "decode":
        c_shard = tree_bytes_per_chip(
            cache_specs(cfg, cell.global_batch, cell.seq_len), mesh, rules)
        n_chips = math.prod(mesh_shape(mesh).values()) \
            if mesh is not None else 1
        logits = cell.global_batch * cfg.vocab_size * 2 / n_chips
        return p_shard + c_shard + logits

    tokens_chip = cell.global_batch * cell.seq_len / batch_shards
    act = ACT_RW * n_layers * tokens_chip * cfg.d_model * 2

    if cell.kind == "prefill":
        c_shard = tree_bytes_per_chip(
            cache_specs(cfg, cell.global_batch, cell.seq_len), mesh, rules)
        return p_shard + c_shard + act

    gathered = p_shard * gather_x
    n_shard_params = p_shard / 2                      # param count per chip
    weights = 3 * gathered
    grads = 2 * p_shard
    opt = 6 * 4 * n_shard_params                      # m, v, master r+w fp32
    saved = 2 * (scan_boundaries(cfg) * tokens_chip * cfg.d_model * 2)
    return weights + grads + opt + 3 * act + saved
