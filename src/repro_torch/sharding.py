"""Logical-axis sharding: MaxText-style rules mapping logical tensor axes to
mesh axes, with divisibility-aware fallbacks, on ``torch.distributed``.

Port of ``repro.sharding``.  Model code annotates tensors with *logical*
axis names via ``shard(x, ...)``; the active :class:`ShardCtx` (mesh + rule
table) decides the physical ``PartitionSpec``, and ``placements`` turns it
into DTensor placements over a ``DeviceMesh``.  With no active context
(single-device runs) ``shard`` is a no-op, so the same model code runs
everywhere.

The rule tables, ``serve_rules_for``, ``train_rules_for`` and ``spec_for``
are the JAX package's, value for value and line for line.  A mesh is read
by axis name through ``mesh_shape``: a ``DeviceMesh`` keeps its sizes as
``mesh_dim_names`` and ``shape``, a test's stand-in mesh (an object with a
``.shape`` dict, as the JAX tests' ``FakeMesh``) as that dict.

Fallback policy: a rule only applies if every mesh axis it names exists in
the mesh.  If the dimension is not divisible by the mesh-axis product, the
rule applies anyway only for axes in ``PAD_OK`` (empty: strict
divisibility everywhere); otherwise a prefix of the axes is tried, then
replication.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Optional

import torch

Rules = dict[str, tuple[str, ...] | str | None]

# Strict divisibility everywhere (see the JAX package for why): head-count
# dims that don't divide the axis fall back to replication; the projection
# *weights* still shard via their flattened (heads*head_dim) dims.
PAD_OK: frozenset = frozenset()

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

TRAIN_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,             # activation d_model
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",        # overridden to None for moe_sharding="tp"
    "expert_mlp": None,        # overridden to "model" for moe_sharding="tp"
    "expert_cap": ("pod", "data"),
    "vocab": "model",
    "w_embed": ("pod", "data"),  # weight d_model dim: FSDP / ZeRO-3
    "kv_seq": None,
    "ssm_heads": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "lru": "model",
    "layers": None,
    "src": None,
    # remat-saved group boundaries; "model" for wide models shards the
    # saved residual stream over seq (sequence-parallel checkpoint storage)
    "seq_remat": None,
}

# Serving: weights TP-only (latency), caches sequence-sharded over "model"
# (kv head counts rarely divide 16; sequence always does at 32k+).
SERVE_RULES: Rules = dict(
    TRAIN_RULES,
    w_embed=None,
    kv_seq="model",
    kv_heads=None,           # cache kv-head dim replicated; seq carries TP
)

# Serving for models whose bf16 weights exceed ~8 GiB/chip at TP=16: 2D
# tensor parallelism (d_model over "data" AND heads/ffn over "model").
SERVE_BIG_RULES: Rules = dict(SERVE_RULES, w_embed=("pod", "data"))

# long_500k context-parallel decode: batch==1, so the KV sequence takes both
# axes (524288 / 256 = 2048 per device).
SERVE_CP_RULES: Rules = dict(SERVE_RULES, kv_seq=("data", "model"),
                             batch=None)


def serve_rules_for(cfg, shape_name: str) -> Rules:
    rules = SERVE_RULES
    if cfg.param_count() * 2 / 16 > 8 * 2 ** 30:  # >8 GiB bf16/chip at TP=16
        rules = SERVE_BIG_RULES
    if shape_name == "long_500k":
        rules = dict(rules, kv_seq=("data", "model"), batch=None)
    if cfg.moe_sharding == "tp":
        rules = dict(rules, experts=None, expert_mlp="model")
    return rules


# Small models: pure data/FSDP parallelism over every mesh axis moves only
# the (small) weights, not activations.
DP_ONLY_TRAIN_RULES: Rules = dict(
    TRAIN_RULES,
    batch=("pod", "data", "model"),
    heads=None, kv_heads=None, mlp=None, vocab=None,
    experts=None, expert_mlp=None, expert_cap=("pod", "data", "model"),
    ssm_heads=None, ssm_inner=None, lru=None,
    w_embed=("pod", "data", "model"),
)

# bf16 weights per device below which pure-FSDP beats TP on a pod
_DP_ONLY_MAX_BYTES = 4 * 2 ** 30


def train_rules_for(cfg, *, dp_only: bool | None = None) -> Rules:
    if dp_only is None:
        dp_only = cfg.param_count() * 2 <= _DP_ONLY_MAX_BYTES \
            and cfg.num_experts == 0
    if dp_only:
        return DP_ONLY_TRAIN_RULES
    rules = TRAIN_RULES
    if cfg.moe_sharding == "tp":
        rules = dict(rules, experts=None, expert_mlp="model")
    if cfg.d_model >= 6144:
        # wide models: store the saved group boundaries sequence-sharded
        # over "model"
        rules = dict(rules, seq_remat="model")
    return rules


# ---------------------------------------------------------------------------
# Partition specs and placements
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh-axis name,
    or a tuple of names (the dim split over those axes, major to minor)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's dimension order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``: one ``Shard(d)`` or
    ``Replicate()`` per mesh dim, in the mesh's dimension order.  A tensor
    dim split over several mesh axes gets ``Shard(d)`` on each; DTensor
    then splits it over those mesh dims in mesh order, major to minor,
    which is the spec's order only if the spec lists the axes in mesh
    order (every rule table does)."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh_shape(mesh))
    owner = {}
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = [order.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: axes {axes} of dim {d} are not in the mesh's "
                f"order {tuple(order)}, which DTensor cannot express")
        owner.update({a: d for a in axes})
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in order)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the port's twin of ``jax.sharding.NamedSharding``.
    ``placements`` are the DTensor placements (needs a ``DeviceMesh`` or
    an object with an ordered ``.shape`` dict); ``shard_shape`` the shape
    of each device's block."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        sizes = mesh_shape(self.mesh)
        out = []
        for dim, entry in zip(shape, tuple(self.spec) + (None,) * (
                len(shape) - len(self.spec))):
            n = math.prod(sizes[a] for a in entry_axes(entry))
            assert dim % n == 0, (shape, self.spec)
            out.append(dim // n)
        return tuple(out)


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------


class ShardCtx:
    def __init__(self, mesh, rules: Rules):
        self.mesh = mesh
        self.rules = rules
        self.shape = mesh_shape(mesh)

    def axis_size(self, names: tuple[str, ...]) -> int:
        return math.prod(self.shape.get(n, 1) for n in names)


_CTX: contextvars.ContextVar[Optional[ShardCtx]] = contextvars.ContextVar(
    "shard_ctx", default=None)


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Rules):
    """Make ``(mesh, rules)`` the active context.  On a ``DeviceMesh``,
    a plain tensor that meets a DTensor inside the context (a RoPE table,
    a mask, a bias, the optimizer's step count) counts as replicated over
    the mesh, as a plain array does under JAX's ``jit``."""
    tok = _CTX.set(ShardCtx(mesh, rules) if mesh is not None else None)
    try:
        with contextlib.ExitStack() as stack:
            if hasattr(mesh, "mesh_dim_names"):
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                stack.enter_context(implicit_replication())
            yield
    finally:
        _CTX.reset(tok)


def current_ctx() -> Optional[ShardCtx]:
    return _CTX.get()


@contextlib.contextmanager
def use_ctx(ctx: Optional[ShardCtx]):
    """Make an existing context (or none) the active one: for code that
    runs on another thread, such as the backward pass's recomputation of
    a checkpointed block on the card's autograd thread, where the
    caller's context variable is not set."""
    tok = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(tok)


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------


def spec_for(axes: tuple[Optional[str], ...], shape: tuple[int, ...],
             ctx: ShardCtx) -> PartitionSpec:
    assert len(axes) == len(shape), (axes, shape)
    used: set[str] = set()
    parts = []
    for dim, name in zip(shape, axes):
        entry = ctx.rules.get(name) if name else None
        if entry is None:
            parts.append(None)
            continue
        mesh_axes = (entry,) if isinstance(entry, str) else tuple(entry)
        mesh_axes = tuple(a for a in mesh_axes
                          if a in ctx.shape and a not in used)
        if not mesh_axes:
            parts.append(None)
            continue
        n = ctx.axis_size(mesh_axes)
        if dim % n != 0:
            # try a prefix of the axes (e.g. batch over ("pod","data"))
            while mesh_axes and dim % ctx.axis_size(mesh_axes) != 0:
                mesh_axes = mesh_axes[:-1]
            if not mesh_axes:
                parts.append(None)
                continue
        used.update(mesh_axes)
        parts.append(mesh_axes[0] if len(mesh_axes) == 1 else mesh_axes)
    return P(*parts)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


# ---------------------------------------------------------------------------
# Redistribution: c10d's in-place collectives on the local blocks
# ---------------------------------------------------------------------------

_REDUCE_OPS = {"sum": "SUM", "avg": "SUM", "max": "MAX", "min": "MIN"}


def _placement_kind(pl) -> str:
    """"shard", "replicate" or "partial"; a placement this module does not
    move (a strided shard, a norm's partial) raises."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    kind = {Shard: "shard", Replicate: "replicate", Partial: "partial"}.get(
        type(pl))
    if kind is None or (kind == "partial"
                        and pl.reduce_op not in _REDUCE_OPS):
        raise NotImplementedError(f"redistribute cannot move {pl!r}")
    return kind


def _gather(t: torch.Tensor, d: int, group, n: int) -> torch.Tensor:
    import torch.distributed as dist
    t = t.movedim(d, 0).contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out.movedim(0, d).contiguous()


def _reduce(t: torch.Tensor, op: str, group, n: int) -> torch.Tensor:
    import torch.distributed as dist
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]),
                    group=group)
    return t / n if op == "avg" else t


def _reduce_scatter(t: torch.Tensor, op: str, d: int, group,
                    n: int) -> torch.Tensor:
    import torch.distributed as dist
    t = t.movedim(d, 0).contiguous()
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, op=getattr(
        dist.ReduceOp, _REDUCE_OPS[op]), group=group)
    out = out.movedim(0, d).contiguous()
    return out / n if op == "avg" else out


def _moved(x, to: tuple):
    """The DTensor ``x`` on placements ``to``: each mesh dim's transition
    done on the local block with c10d's in-place collectives over that
    dim's group.  A tensor dim whose split changes on any mesh dim is
    gathered on every mesh dim that splits it (minor first) and cut again
    (major first), so a dim split over several mesh dims keeps DTensor's
    major-to-minor block order.  A mesh dim of one rank moves nothing."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh, src = x.device_mesh, tuple(x.placements)
    kind = _placement_kind
    changed = {pl.dim for a, b in zip(src, to) if a != b for pl in (a, b)
               if kind(pl) == "shard"}
    for pls in (src, to):
        for d in changed:
            n = math.prod(mesh.size(i) for i, pl in enumerate(pls)
                          if kind(pl) == "shard" and pl.dim == d)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split evenly over {pls}")
    t, cur = x.to_local(), list(src)
    for i in reversed(range(mesh.ndim)):    # gathers and all-reduces
        n, a = mesh.size(i), src[i]
        if kind(a) == "shard" and a.dim in changed:
            if n > 1:
                t = _gather(t, a.dim, mesh.get_group(i), n)
            cur[i] = Replicate()
        elif kind(a) == "partial" and kind(to[i]) == "replicate":
            if n > 1:
                t = _reduce(t, a.reduce_op, mesh.get_group(i), n)
            cur[i] = Replicate()
    for i in range(mesh.ndim):              # cuts and reduce-scatters
        n, a, b = mesh.size(i), cur[i], to[i]
        if a == b:
            continue
        if kind(b) != "shard":
            raise NotImplementedError(f"redistribute: {a!r} -> {b!r}")
        if n > 1 and kind(a) == "partial":
            t = _reduce_scatter(t, a.reduce_op, b.dim, mesh.get_group(i),
                                n)
        elif n > 1:
            size = t.shape[b.dim] // n
            t = t.narrow(b.dim, mesh.get_local_rank(i) * size,
                         size).contiguous()
    return DTensor.from_local(t, mesh, to, run_check=False, shape=x.shape,
                              stride=x.stride())


class _Redistribute(torch.autograd.Function):
    """``_moved`` with DTensor's backward for the same transition: the
    gradient goes back onto the input's placements, but where the input
    was partial, a replicated or sharded gradient is left (or gathered)
    replicated, as ``DTensor.redistribute``'s backward does, and a
    partial one is left as it is (a mean's partial input takes a partial
    sum's gradient, which DTensor cannot turn into a partial mean; each
    holds the same value)."""

    @staticmethod
    def forward(ctx, x, to):
        ctx.src = tuple(x.placements)
        return _moved(x, to)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        to = tuple(src if not src.is_partial() else cur if cur.is_partial()
                   else Replicate() for cur, src in zip(g.placements, ctx.src))
        return (g if tuple(g.placements) == to else _moved(g, to)), None


def redistribute(x: torch.Tensor, to) -> torch.Tensor:
    """The DTensor ``x`` on placements ``to`` (one per mesh dim: the
    transitions are Shard(d) -> Replicate, an all-gather on d; Partial ->
    Replicate, an all-reduce; Partial -> Shard(d), a reduce-scatter on d;
    Replicate -> Shard(d), this rank's slice; Shard(d) -> Shard(e), a
    gather and a slice), through c10d's in-place collectives over
    ``mesh.get_group(dim)``: the same path on every backend and device,
    never torch's functional collectives, which DTensor's own
    ``redistribute`` takes.  Differentiable."""
    to = tuple(to)
    if tuple(x.placements) == to:
        return x
    return _Redistribute.apply(x, to)


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """The whole of the DTensor ``x`` on every rank, as a plain tensor
    (``DTensor.full_tensor`` through ``redistribute``); a plain tensor as
    it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return redistribute(x, [Replicate()] * x.device_mesh.ndim).to_local()


def sum_partials(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its partial sums summed: replicated over each mesh dim
    on which the DTensor ``x`` is partial (an all-reduce); a plain tensor
    as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return redistribute(x, [Replicate() if pl.is_partial() else pl
                            for pl in x.placements])


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Redistribute ``x`` by logical axis names: a no-op without a context
    or on a plain tensor, ``redistribute(x, placements)`` on a DTensor
    under one."""
    ctx = current_ctx()
    if ctx is None or not is_dtensor(x):
        return x
    spec = spec_for(axes, tuple(x.shape), ctx)
    return redistribute(x, placements(spec, ctx.mesh))


def split_last(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n*d) -> (..., n, d).  A DTensor whose last dim is split over
    more ranks than divide ``n`` is gathered on that dim first: DTensor
    cannot unflatten it (GSPMD reshards it the same way)."""
    if is_dtensor(x):
        last = x.ndim - 1
        ranks = math.prod(x.device_mesh.size(i)
                          for i, pl in enumerate(x.placements)
                          if pl.is_shard(last))
        if n % ranks:
            from torch.distributed.tensor import Replicate
            x = redistribute(x, [Replicate() if pl.is_shard(last) else pl
                                 for pl in x.placements])
    return x.reshape(x.shape[:-1] + (n, d))


def block_start(axes: tuple[str, ...], block: int) -> int:
    """The first index of this rank's block of a dim split over the active
    context's mesh ``axes`` (major to minor, as ``placements`` splits
    it), ``block`` indices a block; 0 over no axes."""
    ctx, idx = current_ctx(), 0
    for a in axes:
        idx = idx * ctx.shape[a] + ctx.mesh.get_local_rank(a)
    return idx * block


def gather_weight(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w`` gathered on each mesh dim that splits the rows of ``x`` (its
    dims but the last): FSDP's weight gather, which GSPMD places for the
    reference.  Left to itself, DTensor contracts over a weight dim that
    such a mesh dim splits and reduce-scatters the product: activation-
    sized collectives where the weight's are enough."""
    if not (is_dtensor(w) and is_dtensor(x)):
        return w
    rows = {i for i, pl in enumerate(x.placements)
            if pl.is_shard() and pl.dim < x.ndim - 1}
    if not any(pl.is_shard() for i, pl in enumerate(w.placements)
               if i in rows):
        return w
    from torch.distributed.tensor import Replicate
    return redistribute(w, [Replicate() if i in rows and pl.is_shard()
                            else pl for i, pl in enumerate(w.placements)])


def local_blocks(fn, args, in_specs, out_specs):
    """``fn(*args)`` run by every rank on its own blocks: the twin of
    ``shard_map`` for code that needs no communication under these specs
    (attention over its rows and heads, a scan over its rows and SSM
    heads).  Under a context and with a DTensor among ``args``, each
    argument is redistributed onto its spec in ``in_specs`` by
    ``redistribute`` (a plain tensor counts as replicated and is cut to
    the rank's block), ``fn`` runs on the local tensors, and its output
    (one tensor, or a tuple with ``out_specs`` a tuple) is put together
    by ``out_specs``.  An
    input replicated over a mesh axis along which the work is split (some
    input is sharded on it: rows over "data", say, for a weight that every
    rank applies to its own rows) gets its gradient summed over that axis;
    elsewhere each rank's gradient of its block is the block's whole."""
    ctx = current_ctx()
    if ctx is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = ctx.mesh
    ins = tuple(placements(s, mesh) for s in in_specs)
    # onto ``in_specs`` here, so that ``local_map`` has nothing to move
    args = tuple(redistribute(a if is_dtensor(a) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False), pl)
        for a, pl in zip(args, ins))
    split = {i for pl in ins for i, q in enumerate(pl)
             if not isinstance(q, Replicate)}
    grads = tuple(tuple(Partial() if i in split and isinstance(q, Replicate)
                        else q for i, q in enumerate(pl)) for pl in ins)
    # one output: its placements as a list (a tuple means one per output)
    out = tuple(list(placements(o, mesh)) for o in out_specs) \
        if isinstance(out_specs, tuple) and not isinstance(
            out_specs, PartitionSpec) else list(placements(out_specs, mesh))
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=False)(*args)


class _Psum(torch.autograd.Function):
    """Sum of every rank's ``y`` over one mesh axis's group.  The result
    is replicated over that axis, so each rank's gradient of it is
    already the whole gradient of the sum: the backward passes it on
    unchanged."""

    @staticmethod
    def forward(ctx, y, group):
        import torch.distributed as dist
        y = y.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(y: torch.Tensor, axis: str) -> torch.Tensor:
    """``jax.lax.psum`` over the active context's mesh axis ``axis``, for
    the plain tensors of a ``local_blocks`` body.  An axis of one rank
    sums nothing and is skipped."""
    ctx = current_ctx()
    if ctx.shape[axis] == 1:
        return y
    return _Psum.apply(y, ctx.mesh.get_group(axis))


# the in-place collectives of ``torch.distributed`` that this module and
# the models call -> the collective's name; ``CollectiveCount`` counts them
_C10D_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                     "all_reduce": "all-reduce",
                     "reduce_scatter_tensor": "reduce-scatter"}


class CollectiveCount:
    """Every collective issued while the object is entered, by path:
    ``functional`` counts the calls into each public function of
    ``torch.distributed._functional_collectives`` (the path DTensor's own
    redistribution takes), ``counts`` and ``bytes`` the calls of
    ``torch.distributed``'s in-place collectives by kind, each call its
    largest buffer (an all-gather's result, a reduce-scatter's operand).
    It wraps those module attributes while entered, so it costs nothing
    per op; ``snapshot()`` reads the totals so far."""

    def __init__(self):
        self.functional: dict[str, int] = {}
        self.counts = {k: 0 for k in _C10D_COLLECTIVES.values()}
        self.bytes = dict(self.counts)
        self._saved: list = []

    def snapshot(self) -> dict:
        return {"functional": dict(self.functional),
                "counts": dict(self.counts), "bytes": dict(self.bytes)}

    def _wrap(self, module, name, count):
        fn = getattr(module, name)

        def wrapped(*args, **kw):
            count(args, kw)
            return fn(*args, **kw)
        self._saved.append((module, name, fn))
        setattr(module, name, wrapped)

    def __enter__(self):
        import inspect

        import torch.distributed as dist
        from torch.distributed import _functional_collectives as funcol

        def functional(name):
            def count(args, kw):
                self.functional[name] = self.functional.get(name, 0) + 1
            return count

        def c10d(name):
            kind = _C10D_COLLECTIVES[name]

            def count(args, kw):
                t = args[0] if name != "reduce_scatter_tensor" else (
                    args[1] if len(args) > 1 else kw["input"])
                self.counts[kind] += 1
                self.bytes[kind] += t.numel() * t.element_size()
            return count
        for name, fn in vars(funcol).items():
            if inspect.isfunction(fn) and not name.startswith("_") \
                    and fn.__module__ == funcol.__name__:
                self._wrap(funcol, name, functional(name))
        for name in _C10D_COLLECTIVES:
            self._wrap(dist, name, c10d(name))
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self._saved):
            setattr(module, name, fn)
        self._saved.clear()
        return False


def named_sharding(axes: tuple[Optional[str], ...], shape: tuple[int, ...],
                   mesh, rules: Rules) -> NamedSharding:
    return NamedSharding(mesh, spec_for(axes, shape, ShardCtx(mesh, rules)))


def distribute(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """Distribute the full tensor ``x`` (the same on every rank) onto
    ``sharding``: each rank keeps only its own block, cut from its own
    copy, so that placing runs no collective (no scatter or broadcast
    from rank 0)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)


# ---------------------------------------------------------------------------
# Memory-control-plane view
# ---------------------------------------------------------------------------


def mesh_topology(mesh, budget_per_device: int):
    """The host broker's view of ``mesh``: a uniform ``DeviceTopology``
    (``repro_torch.cluster.topology``) with one account of
    ``budget_per_device`` broker units per mesh device.  A replica whose
    KV is sharded over this mesh holds one unit shard per device, so the
    ledger's per-device conservation law tracks real per-device memory,
    not one fictional flat pool."""
    from repro_torch.cluster.topology import DeviceTopology

    assert budget_per_device > 0
    return DeviceTopology(budgets=(budget_per_device,)
                          * math.prod(mesh_shape(mesh).values()))
