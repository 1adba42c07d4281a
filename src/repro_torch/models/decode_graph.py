"""The decode step of one engine, replayed from a CUDA graph.

A decode step launches some 30 device operations a block (910 for
qwen2-7b's 28 blocks; some 80 before the attention front end became one
kernel, ``ops.decode_qkv_rope``), each a few microseconds of device work
behind tens of microseconds of Python, so an eager step keeps the card idle
most of the time.  ``DecodeGraph`` captures ``model.decode_step`` once for a given arena
and replays it: the same kernels, on the same inputs, in the same order,
from one launch.

What a captured step depends on is fixed at capture: the addresses, shapes
and strides of the cache leaves, and the static buffers of the tokens and
positions.  ``cache_key`` is what the code can observe of the first: a plug
or an unplug replaces the cache tensors (``cache_grow_rows``,
``cache_slice_rows``) and changes it; a cold start or a restore writes rows
in place (``cache_write_row``, ``cache_write_rows``) and keeps it.  The
first step of a new key runs eagerly and drops the old graph, so a stale
graph never replays into freed memory; the second step with that key
captures; every later one replays.  The graph holds no reference to the
caches, so an unplug frees the dropped rows at once.

Where the step can be captured as it stands (``eligible``): on a CUDA
device, with no sharding context (the mesh path's collectives stay eager),
and every block an attention block of a decoder-only model (the recurrent
blocks and the encoder-decoder family stay eager).  Elsewhere every step
runs eagerly from the same loaded buffers.  So ``DecodeGraph`` is how an
engine runs each of its decode steps, captured or not; the class keeps the
name of what it adds to an eager step, the graph.

A model with experts gets a ``moe.Probe`` (``probe``): each of its steps,
eager or captured, runs under it, so every replay writes the expert
blocks' counters and timing events again, and ``probe.read()`` after a
step reads them.  A model without experts has none, and its graph gains
no node.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.elastic import sync
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models import moe, transformer
from repro_torch.models.layers import tree_leaves
from repro_torch.sharding import current_ctx


def eligible(cfg, device) -> bool:
    """Whether ``cfg``'s decode step on ``device`` can be captured as it
    stands, under the sharding context active now."""
    return (torch.device(device).type == "cuda" and current_ctx() is None
            and cfg.family != "audio"
            and all(kind in transformer.ATTN_KINDS
                    for kind in cfg.block_pattern + cfg.tail_pattern))


def cache_key(caches) -> tuple:
    """The row count, and every cache leaf's address, shape and stride."""
    return (M.cache_num_rows(caches),) + tuple(
        (x.data_ptr(), tuple(x.shape), x.stride())
        for x in tree_leaves(caches))


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream of every capture on ``device``: cuBLAS keeps a
    workspace for each stream it runs on for the life of the process (32
    MiB on the H100), so each engine's own stream would hold one more."""
    return torch.cuda.Stream(device)


class DecodeGraph:
    """The decode step of one engine: the static device buffers of its
    inputs and, where the step can be captured, at most one graph, for the
    key of its caches."""

    def __init__(self, cfg, params, device):
        self.cfg, self.params = cfg, params
        self.device = torch.device(device)
        self.tokens = self.positions = None
        self.key = None
        self.graph = None
        # ``ops.LAUNCHES`` counted by the captured step: a replay adds them
        self.launches: dict[str, int] = {}
        self.probe = moe.Probe(cfg, self.device) if cfg.num_experts else None

    def load(self, tokens, positions) -> None:
        """Copy the host's tokens (rows, 1) and positions (rows,) into the
        static buffers, new ones when the row count changed."""
        if self.tokens is None or self.tokens.shape != tokens.shape:
            self.tokens = torch.empty_like(tokens, device=self.device)
            self.positions = torch.empty_like(positions, device=self.device)
        self.tokens.copy_(tokens)
        self.positions.copy_(positions)

    def warm(self, partition_tokens: int) -> None:
        """One throw-away eager step on a fresh one-row cache of
        ``partition_tokens`` slots, so that the first timed step pays no
        library initialisation on the device."""
        caches = M.init_caches(self.cfg, 1, partition_tokens,
                               device=self.device)
        toks = torch.zeros((1, 1), dtype=torch.int32, device=self.device)
        pos = torch.zeros((1,), dtype=torch.int32, device=self.device)
        M.decode_step(self.cfg, self.params, toks, pos, caches)
        sync(caches)

    def step(self, caches) -> str:
        """One decode step over ``caches`` (updated in place) from the
        loaded inputs: ``"eager"`` where the step cannot be captured
        (``eligible``) and for the first step of a new key, ``"capture"``
        for the second, ``"replay"`` after."""
        key = cache_key(caches) if eligible(self.cfg, self.device) else None
        if key is None or key != self.key:
            self.graph, self.key = None, key
            self._decode(caches)
            return "eager"
        if self.graph is None:
            self._capture(caches)
            return "capture"
        self.graph.replay()
        for name, n in self.launches.items():
            ops.LAUNCHES[name] += n
        return "replay"

    def _capture(self, caches) -> None:
        """The step run eagerly on the capture stream (its warm-up, and
        this step's work), then captured: a capture runs nothing, so its
        launch counts are taken back and kept for the replays."""
        current = torch.cuda.current_stream(self.device)
        stream = _capture_stream(self.device)
        stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            self._decode(caches)
            counted = dict(ops.LAUNCHES)
            graph.capture_begin()
            self._decode(caches)
            graph.capture_end()
        current.wait_stream(stream)
        self.launches = {k: ops.LAUNCHES[k] - n for k, n in counted.items()}
        ops.LAUNCHES.update(counted)
        self.graph = graph

    def _decode(self, caches) -> None:
        with moe.probing(self.probe):
            M.decode_step(self.cfg, self.params, self.tokens, self.positions,
                          caches)
