"""Elastic serving engine: the FaaS-runtime analogue of paper §4.1.

Port of ``repro.serving.engine``: the hotmem, vanilla and static modes.

One engine = one replica (VM).  Requests (function invocations) are admitted
into arena partitions, prefilled (cold start), batch-decoded (continuous
batching), kept warm for ``keep_alive`` (idle container pool), recycled, and
the arena is resized up/down a bucket ladder as demand moves (plug/unplug).

Start paths, fastest first (each leaves its own ``StepEvent``):
  warm_start — a kept-alive container's partition is re-bound by metadata
               adoption (zero data movement, zero wall);
  restore    — the host snapshot pool held the function's prefix KV; one
               host->device blob copy (or none: an on-device remap) and one
               fused scatter launch, no model compute;
  prefill    — cold start: full prompt forward pass.
When a warm container expires past keep-alive, its partition is offered
to the broker's snapshot pool first (``_offer_snapshot``: one fused gather
launch plus one device->host copy) and only then released.

Timebase: a *virtual clock* advanced by the measured wall time of every
device operation (prefill, decode step, snapshot, resize).  Every timed
region ends in a device synchronise, so the wall measures the work and not
its launch.

Spans (``repro_torch.spans``): while a profiler or ``spans.enable()``
records, each scheduler iteration leaves a ``tick`` span on the host's
``perf_counter`` clock, with one child for each of its parts (``grants``,
``orders``, ``admit``, ``decode``, ``recycle``, ``resize``); below them the
start paths (``start.cold``, ``start.warm``, ``start.restore``), the
snapshot capture, ``plug`` and ``unplug``, and the decode step's
``decode.inputs``, ``decode.dispatch`` (the model's blocks enqueued, or
the step's graph replayed; its ``graph`` attribute says which),
``decode.sync``, ``decode.moe`` (a model with experts: the device
readings of the step's expert blocks, ``moe.Probe.read``) and
``decode.account``.  ``request.queue`` and ``request``
run from a submission to its admission and to its end.  Otherwise a span
costs one flag test, and the virtual clock never reads them.

Device: the engine runs where ``params`` live.  On the card every kernel of
the path is the hand-written one (``repro_torch.kernels.ops``), built and
loaded when the engine is made, outside every timed region; on the CPU the
same wrappers run their plain versions.  Where the step can be captured
(``models.decode_graph.eligible``), the card replays it from a CUDA graph
while the arena keeps its caches, and steps it eagerly, then captures it,
after each resize.

Modes (paper Fig. 8/9/10):
  hotmem  — partition arena; shrink is metadata + prefix slice.
  vanilla — same compute, but a physical paged twin of the KV leaves is
            maintained (owned by the arena); shrink must first run real
            migration copies (one ``kv_compact`` launch on the card).
  static  — statically over-provisioned (never resizes).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.cluster.host import (AlwaysGrantBroker, Grant, MemoryBroker,
                                      ReclaimOrder)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.arena import ArenaSpec, ReclaimEvent
from repro_torch.core.elastic import (ElasticArena, bucket_ladder, sync,
                                      target_bucket)
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models.decode_graph import DecodeGraph
from repro_torch.models.layers import tree_leaves, tree_unflatten
from repro_torch.serving.request import Request, State, slo_tier_of
from repro_torch.spans import begin, recording, span


# ---------------------------------------------------------------------------
# Snapshot data plane: staged row blobs + content-addressed pagination.
# Pure host-side logic lives at module level so it is testable without
# booting an engine.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StagedRow:
    """Host-side snapshot payload: ONE contiguous byte buffer (the fused
    capture kernel's single device->host copy) plus enough metadata to
    carve it back into a batch==1 cache tree of zero-copy views."""
    blob: np.ndarray             # (row_bytes,) uint8
    treedef: Any                 # cache tree structure (``tree_flatten``)
    metas: tuple                 # ((row-slice shape, torch dtype name), ...)

    @property
    def nbytes(self) -> int:
        return int(self.blob.nbytes)

    def tree(self):
        return blob_to_row_tree(self.blob, self.treedef, self.metas)


def blob_to_row_tree(blob_u8: np.ndarray, treedef, metas):
    """Carve a staged row blob into a batch==1 cache tree of zero-copy
    tensor views — no bytes move; every leaf aliases the blob."""
    raw = torch.from_numpy(blob_u8)
    leaves, off = [], 0
    for shape, dtype in metas:
        dt = getattr(torch, dtype)
        n = int(np.prod(shape)) * dt.itemsize
        leaves.append(raw[off:off + n].view(dt).reshape(shape))
        off += n
    assert off == blob_u8.nbytes, (off, blob_u8.nbytes)
    return tree_unflatten(treedef, leaves)


def paginate_blob(blob_u8, units: int, page_bytes: int,
                  n_dev: int = 1) -> list:
    """Split a staged row blob into fixed-size content-addressed pages.

    Each chunk is hashed in place (memoryview slices) and keyed by content
    digest with the page's unit charge folded in, so one digest always
    means one (content, units) pair.  Units spread over the pages in whole
    mesh stripes; short manifests may carry zero-unit tail pages.  The
    digest formula is the JAX package's, and the blob's byte image is the
    JAX blob's, so digests agree across the two packages."""
    mv = memoryview(np.ascontiguousarray(blob_u8)).cast("B")
    chunks = [mv[i:i + page_bytes]
              for i in range(0, len(mv), page_bytes)] or [memoryview(b"")]
    assert units % n_dev == 0, (units, n_dev)
    base, rem = divmod(units // n_dev, len(chunks))
    specs = []
    for i, chunk in enumerate(chunks):
        u = (base + (1 if i < rem else 0)) * n_dev
        digest = "%s-%d" % (hashlib.sha256(chunk).hexdigest()[:16], u)
        specs.append((digest, u, len(chunk), bytes(chunk)))
    return specs


def assemble_pages(specs: list) -> np.ndarray:
    """Concatenate page payloads into ONE contiguous uint8 host buffer —
    the single host-side copy a paged restore pays before its one fused
    host->device transfer."""
    total = sum(b for _d, _u, b, _p in specs)
    out = np.empty(total, np.uint8)
    off = 0
    for _d, _u, b, p in specs:
        out[off:off + b] = np.frombuffer(p, np.uint8, count=b)
        off += b
    return out


@dataclasses.dataclass
class StepEvent:
    t: float                 # virtual time at the end of the event
    kind: str                # decode | prefill | plug | unplug | ...
    wall_s: float
    detail: dict[str, Any] = dataclasses.field(default_factory=dict)


class ServeEngine:
    """One replica.  The constructor is the JAX engine's without
    ``snapshot_impl``: the device of ``params`` picks the kernels.
    ``seed`` seeds the vanilla manager's block hand-out order."""

    def __init__(self, cfg: ModelConfig, params, spec: ArenaSpec, *,
                 mode: str = "hotmem", keep_alive: float = 10.0,
                 headroom: int = 1, seed: int = 0, prewarm: bool = True,
                 broker: Optional[MemoryBroker] = None,
                 replica_id: str = "r0",
                 snapshot_page_bytes: Optional[int] = None):
        assert mode in ("hotmem", "vanilla", "static")
        assert snapshot_page_bytes is None or snapshot_page_bytes > 0
        if mode == "vanilla":
            assert cfg.family not in ("ssm", "hybrid"), \
                "paged baseline mirrors token-extensive KV only"
        self.cfg = cfg
        self.params = params
        self.spec = spec
        self.mode = mode
        self.keep_alive = keep_alive
        self.headroom = headroom
        self.device = tree_leaves(params)[0].device
        if self.device.type == "cuda":
            ops.load()          # kernel build + module load: set-up, untimed
        self.ladder = bucket_ladder(spec.n_partitions,
                                    min_units=min(2, spec.n_partitions))
        start = spec.n_partitions if mode == "static" else self.ladder[0]
        # vanilla's model-facing row view stays full-size (compute reads
        # through block tables conceptually); its *physical* pool resizes
        rows = spec.n_partitions if mode in ("static", "vanilla") else start
        self.caches = M.init_caches(cfg, rows, spec.partition_tokens,
                                    device=self.device)
        # physical paged twin of token-extensive KV leaves (vanilla only),
        # owned by the arena (``pool``); for hotmem/static the arena is
        # metadata-only and the engine owns the device tree
        self.arena = ElasticArena(
            cfg, spec, mode,
            caches=self._make_pool(start) if mode == "vanilla" else None,
            seed=seed, grant=self._host_grant, release=self._host_release,
            start=start)
        # broker blocks in one native unit of the arena's manager: a block
        # for vanilla, a partition for hotmem and static
        self._bpu = 1 if mode == "vanilla" else spec.blocks_per_partition

        # host control plane: growth is a *request* to the broker, never a
        # unilateral resize.  Standalone engines get an unmetered broker.
        # Async pipeline state: reclaim orders this VM owes the host
        # (drained incrementally at tick boundaries) and open grants whose
        # pending fills we claim as victims drain.
        self.replica_id = replica_id
        self._reclaim_orders: deque[ReclaimOrder] = deque()
        self._open_grants: list[Grant] = []
        self.drain_parts_per_tick = 1
        self.broker = broker if broker is not None else AlwaysGrantBroker()
        # sharded hosts: each partition must stripe evenly over the mesh
        topo = getattr(self.broker, "topology", None)
        self._n_dev = topo.n_devices if topo is not None else 1
        if self._n_dev > 1:
            assert spec.blocks_per_partition % self._n_dev == 0, \
                f"partition of {spec.blocks_per_partition} blocks does " \
                f"not stripe over {self._n_dev} devices"
            # vanilla plugs/unplugs single blocks, which cannot stripe
            assert mode != "vanilla", \
                "vanilla mode is incompatible with a sharded host"
        self.broker.register(
            replica_id, start * spec.blocks_per_partition,
            reclaim=self.reclaim_for_broker, load=self.load, mode=mode,
            order_sink=None if mode == "static" else self._enqueue_order,
            shards=self._n_dev)

        self.now = 0.0
        self.pending: deque[Request] = deque()
        self.active: dict[str, Request] = {}
        self.warm: dict[str, list[tuple[float, str, int]]] = {}
        self.done: list[Request] = []
        self.events: list[StepEvent] = []
        # authoritative start-path counters (outcomes, not route-time picks)
        self.cold_starts = 0
        self.warm_starts = 0
        self.restore_starts = 0
        self.remote_restore_starts = 0
        # decode steps captured into, and replayed from, a CUDA graph
        self.graph_captures = 0
        self.graph_replays = 0
        self._graph = DecodeGraph(cfg, params, self.device)
        self._prof_tokens: dict[str, int] = {}   # profile -> prompt tokens
        # content-addressed capture (``snapshot_page_bytes`` set): offered
        # partitions split into pages keyed by content hash; ``_mapped``
        # remembers which page digests this replica already materialized
        self.snapshot_page_bytes = snapshot_page_bytes
        self._mapped: set[str] = set()
        self._snap_layout = None
        # digest -> (device u8 blob, start, stop): where page bytes are
        # already resident ON DEVICE.  A fully-mapped local CoW restore
        # reassembles its row from these slices — zero h2d payload bytes.
        self._device_pages: dict[str, tuple] = {}
        self._row_req: dict[int, Request] = {}
        # rid -> (request.queue, request) spans of a recorded submission
        self._req_spans: dict[str, tuple] = {}
        if prewarm and mode in ("hotmem", "vanilla"):
            self._graph.warm(spec.partition_tokens)

    # ------------------------------------------------------------ plumbing
    def _host_grant(self, native: int) -> int:
        """Arena host gate: convert this replica's native units (partitions
        for hotmem, blocks for vanilla) to broker blocks, request a grant,
        and floor the immediate portion back to native granularity.  A sync
        broker may steal inline (its stall is charged to our clock); an
        async broker leaves the deficit pending on the grant instead."""
        g = self.broker.request_grant(self.replica_id, native * self._bpu)
        if g.stall_seconds:
            self.now += g.stall_seconds
            self.events.append(StepEvent(self.now, "stall", g.stall_seconds,
                                         {"units": g.granted}))
        if not g.done:
            self._open_grants.append(g)
        return self._native(g.granted)

    def _native(self, blocks: int) -> int:
        """Broker blocks as whole native units; a remainder short of one
        unit is of no use, and goes back to the broker."""
        if blocks % self._bpu:
            self.broker.release_units(self.replica_id, blocks % self._bpu)
        return blocks // self._bpu

    def _enqueue_order(self, order: ReclaimOrder) -> None:
        """Order sink the broker calls under pressure: queue the shrink,
        to be drained incrementally at our own tick boundaries."""
        self._reclaim_orders.append(order)

    def _host_release(self, native: int) -> None:
        self.broker.release_units(self.replica_id, native * self._bpu)

    def _make_pool(self, parts: int):
        """Physical paged twin: every token-extensive leaf becomes a flat
        (NB, block_tokens, ...) block pool — one manager block id maps to
        the same token range across all layers, the paper's whole-memory-
        block semantics.  Non-token leaves are skipped.  Each pool leaf is
        contiguous storage of its own: the moved and reshaped row cache is
        a strided view of it, which the in-place migration must not
        write."""
        bt = self.spec.block_tokens
        t_part = self.spec.partition_tokens
        pools = []

        def to_pool(x, ax):
            tok_ax = ax + 1
            if x.dim() <= tok_ax or x.shape[tok_ax] != t_part:
                return
            if ax == 1:                       # (G, B, T, ...) -> (B, T, G...)
                x = x.movedim(0, 2)[:parts]
            else:
                x = x[:parts]
            nb = parts * (t_part // bt)
            pools.append(x.reshape((nb, bt) + tuple(x.shape[2:])).clone(
                memory_format=torch.contiguous_format))

        M.cache_axis_map(self.caches, to_pool)
        return pools or None

    @property
    def pool(self):
        """The vanilla block pool (the arena's tensors), else None."""
        return self.arena.caches

    def _rows(self) -> int:
        return M.cache_num_rows(self.caches)

    def _units(self) -> int:
        """The arena's size in whole partitions."""
        return self.arena.units() * self._bpu \
            // self.spec.blocks_per_partition

    def _sync(self) -> None:
        sync(self.caches)

    def _allocator(self) -> Optional[tuple]:
        """Device allocations and frees, allocation retries and reserved
        bytes of the caching allocator (the card only), for the ``plug``
        and ``unplug`` spans."""
        if self.device.type != "cuda":
            return None
        s = torch.cuda.memory_stats(self.device)
        return tuple(s.get(k, 0) for k in (
            "num_device_alloc", "num_device_free", "num_alloc_retries",
            "reserved_bytes.all.current"))

    def _note_allocator(self, s, before) -> None:
        after = self._allocator()
        if before is None or after is None:
            return
        s.note(device_allocs=after[0] - before[0],
               device_frees=after[1] - before[1],
               alloc_retries=after[2] - before[2],
               reserved_before=before[3], reserved_after=after[3])

    def _span_admitted(self, req: Request, path: str) -> None:
        """End a recorded submission's ``request.queue`` span."""
        s = self._req_spans.get(req.rid)
        if s:
            s[0].end()
            s[1].note(start=path)

    # ------------------------------------------------------------- submit
    def submit(self, req: Request) -> None:
        self._prof_tokens[req.profile.name] = req.profile.prompt_tokens
        self.pending.append(req)
        whole = begin("request", rid=req.rid)
        if whole:
            self._req_spans[req.rid] = (begin("request.queue", rid=req.rid),
                                        whole)

    # -------------------------------------------------------------- admit
    def _try_admit(self) -> None:
        still = deque()
        while self.pending:
            req = self.pending.popleft()
            if req.submit_s > self.now:
                still.append(req)
                continue
            # batch-tier traffic is deliberately started cold: it must not
            # consume a warm container or a pooled snapshot
            batch = slo_tier_of(req) == "batch"
            warm = None if batch else self.warm.get(req.profile.name)
            if warm:
                _, old_rid, row = warm.pop()
                self._start_warm(req, old_rid, row)
                continue
            got = self.arena.admit(req.rid)
            if got is None:
                still.append(req)
                continue
            row = got if self.mode != "vanilla" else self._alloc_row(req)
            if row is None:
                still.append(req)
                continue
            # probe restore feasibility first (no accounting)
            snap = self.broker.snapshot_lookup(req.profile.name) \
                if self.mode == "hotmem" and not batch \
                and self.broker.snapshot_restorable(req.profile.name) \
                else None
            if snap is not None:
                self._start_restore(req, row, snap)
            else:
                self._start_cold(req, row)
        self.pending = still

    def _alloc_row(self, req) -> Optional[int]:
        used = set(self._row_req)
        for entries in self.warm.values():          # warm rows stay reserved
            used.update(row for _, _, row in entries)
        for r in range(self._rows()):
            if r not in used:
                return r
        return None

    def _activate(self, req: Request, row: int) -> None:
        """Shared tail of every start path (cold / warm / restore): the
        prompt KV is resident in ``row``, bind the request and enter the
        decode loop."""
        prof = req.profile
        self.arena.on_tokens(req.rid, prof.prompt_tokens)
        req.position = prof.prompt_tokens
        req.target_tokens = prof.prompt_tokens + prof.decode_tokens
        req.state = State.RUNNING
        self._row_req[row] = req
        self.active[req.rid] = req

    def _start_cold(self, req: Request, row: int) -> None:
        prof = req.profile
        with span("start.cold", rid=req.rid,
                  prompt_tokens=prof.prompt_tokens):
            self._span_admitted(req, "cold")
            req.partition = row
            req.admitted_s = self.now
            req.state = State.PREFILL
            prompt = torch.full((1, prof.prompt_tokens),
                                hash(prof.name) % 97 + 1, dtype=torch.int32,
                                device=self.device)
            t0 = time.perf_counter()
            row_caches = M.init_caches(self.cfg, 1,
                                       self.spec.partition_tokens,
                                       device=self.device)
            M.prefill(self.cfg, self.params, {"tokens": prompt}, row_caches)
            self.caches = M.cache_write_row(self.caches, row_caches, row)
            self._sync()
            wall = time.perf_counter() - t0
            self.now += wall
            self.events.append(StepEvent(self.now, "prefill", wall,
                                         {"rid": req.rid}))
            self._activate(req, row)
            self.cold_starts += 1

    def _start_warm(self, req: Request, old_rid: str, row: int) -> None:
        """Warm start: prompt KV still resident in the partition — skip
        prefill entirely.  The partition is re-bound by metadata adoption,
        zero data movement."""
        with span("start.warm", rid=req.rid, row=row):
            self._span_admitted(req, "warm")
            req.partition = row
            req.admitted_s = self.now
            self.arena.manager.adopt(old_rid, req.rid)
            self._activate(req, row)
            self.warm_starts += 1
            self.events.append(StepEvent(self.now, "warm_start", 0.0,
                                         {"rid": req.rid, "row": row}))

    def _start_restore(self, req: Request, row: int, snap) -> None:
        """Snapshot restore: copy the function's pooled prefix KV into the
        freshly admitted partition — one fused scatter launch, no model
        compute.

        An entry the fleet migrated from another host still owes its
        modeled inter-host transfer wall (``Snapshot.copy_seconds``); the
        first restore claims it and is tagged ``source="remote"``.

        Content-addressed entries restore copy-on-write: pages whose
        digest this replica already materialized are remapped, not
        re-copied — the charged wall scales by the fraction of pages new
        here.  When EVERY page of a local entry is still resident on
        device (``_device_pages``), the row is reassembled from those
        slices on the device: zero host->device bytes.  The event and the
        ``start.restore`` span give the host->device bytes (``h2d_bytes``)
        and whether the row was remapped (``remap``)."""
        with span("start.restore", rid=req.rid, bytes=snap.nbytes) as s:
            self._span_admitted(req, "restore")
            detail = self._restore(req, row, snap)
            if s:
                s.note(h2d_bytes=detail["h2d_bytes"], remap=detail["remap"],
                       source=detail["source"])

    def _restore(self, req: Request, row: int, snap) -> dict:
        req.partition = row
        req.admitted_s = self.now
        req.state = State.PREFILL
        copy_s = snap.claim_copy() if hasattr(snap, "claim_copy") else 0.0
        specs = self.broker.snapshot_page_specs(snap.key) \
            if getattr(snap, "pages", None) is not None else None
        if specs is None and not isinstance(snap.payload, StagedRow):
            raise TypeError(f"snapshot {snap.key!r} holds no staged row "
                            f"or pages to restore from")
        layout = self._snapshot_layout()
        remap = specs is not None and copy_s == 0.0 and \
            all(d in self._device_pages for d, _u, _b, _p in specs)
        t0 = time.perf_counter()
        if remap:
            # fully-mapped local CoW restore: concatenate the mapped
            # on-device byte slices back into a staging blob — no payload
            # byte crosses the host/device boundary
            dev_u8 = torch.cat([dev[s:e] for dev, s, e in
                                (self._device_pages[d]
                                 for d, _u, _b, _p in specs)])
            dev_blob = dev_u8.view(layout.torch_dtype).reshape(
                1, layout.total_elems)
            h2d = 0
        else:
            blob_u8 = self._reassemble(snap.payload, specs) \
                if specs is not None else snap.payload.blob
            host_blob = torch.from_numpy(blob_u8).view(
                layout.torch_dtype).reshape(1, layout.total_elems)
            dev_blob = host_blob.to(self.device)     # ONE fused h2d copy
            h2d = blob_u8.nbytes
        self.caches = M.cache_write_rows(self.caches, dev_blob, [row],
                                         layout=layout)
        self._sync()
        wall = time.perf_counter() - t0
        detail = {"rid": req.rid, "key": snap.key, "bytes": snap.nbytes,
                  "row": row, "source": "remote" if copy_s else "local",
                  "h2d_bytes": h2d, "remap": remap}
        if specs is not None:
            total = len(specs)
            shared = sum(1 for d, _u, _b, _p in specs if d in self._mapped)
            # CoW: only the new pages pay the host->device copy; shared
            # pages are a mapping (the measured wall is the full row
            # write, so scale it by the new-page fraction)
            wall *= (total - shared) / total if total else 1.0
            self._mapped.update(d for d, _u, _b, _p in specs)
            self._index_device_pages(dev_blob, specs)
            detail["pages_total"] = total
            detail["pages_shared"] = shared
        wall += copy_s
        self.now += wall
        if copy_s:
            detail["origin"] = snap.origin_host
            detail["copy_s"] = copy_s
            self.remote_restore_starts += 1
        self.events.append(StepEvent(self.now, "restore", wall, detail))
        self._activate(req, row)
        self.restore_starts += 1
        return detail

    # -------------------------------------------------------------- decode
    def _decode(self) -> None:
        """One decode step over every row, run by the engine's
        ``DecodeGraph``.  Its ``StepEvent`` times the inputs' host->device
        copies, the step and the synchronise."""
        with span("decode.inputs"):
            rows = self._rows()
            toks = torch.zeros((rows, 1), dtype=torch.int32)
            pos = torch.zeros((rows,), dtype=torch.int32)
            for row, req in self._row_req.items():
                assert row < rows, \
                    f"active request {req.rid} bound to row {row} but the " \
                    f"arena holds only {rows} rows — a shrink dropped a " \
                    f"live row (free-suffix invariant violated)"
                pos[row] = req.position
            t0 = time.perf_counter()
            self._graph.load(toks, pos)
        with span("decode.dispatch", rows=rows,
                  batch=len(self._row_req)) as s:
            how = self._graph.step(self.caches)
            self.graph_captures += how == "capture"
            self.graph_replays += how == "replay"
            if s:
                s.note(graph=how)
        with span("decode.sync"):
            self._sync()
            wall = time.perf_counter() - t0
        if self._graph.probe is not None and recording():
            with span("decode.moe") as s:
                s.note(**(self._graph.probe.read() or {}))
        with span("decode.account"):
            self.now += wall
            self.events.append(StepEvent(self.now, "decode", wall,
                                         {"batch": len(self._row_req)}))
            finished = []
            for row, req in list(self._row_req.items()):
                req.position += 1
                if req.first_token_s is None:
                    req.first_token_s = self.now
                if not self.arena.on_tokens(req.rid, 1):
                    req.state = State.KILLED
                    finished.append((row, req))
                    continue
                if req.position >= req.target_tokens:
                    req.state = State.DONE
                    finished.append((row, req))
            for row, req in finished:
                req.done_s = self.now
                self.done.append(req)
                del self.active[req.rid]
                del self._row_req[row]
                s = self._req_spans.pop(req.rid, None)
                if s:
                    s[1].end(state=req.state.name,
                             tokens=req.position - req.profile.prompt_tokens)
                if req.state is State.DONE:
                    # to warm pool: the partition STAYS BOUND (idle
                    # container) until keep-alive expiry recycles it
                    self.warm.setdefault(req.profile.name, []).append(
                        (self.now, req.rid, row))
                # KILLED was already force-released by the manager

    # ------------------------------------------------------------- elastic
    def _snapshot_layout(self):
        """Static blob layout of one arena row (row-slice shapes do not
        depend on the arena's row count, so one layout survives every
        bucket switch)."""
        if self._snap_layout is None:
            self._snap_layout = M.cache_row_layout(self.caches)
        return self._snap_layout

    def _index_device_pages(self, dev_blob, specs: list) -> None:
        """Remember where each page's bytes live ON DEVICE (byte slices of
        the staged blob): a later fully-mapped local CoW restore
        reassembles its row from these slices."""
        dev_u8 = dev_blob.view(torch.uint8).reshape(-1)
        off = 0
        for d, _u, b, _p in specs:
            self._device_pages[d] = (dev_u8, off, off + b)
            off += b

    def _offer_snapshot(self, prof_name: str, rid: str, row: int) -> bool:
        """Persist an about-to-be-recycled warm partition to the host
        snapshot pool instead of discarding its prefix KV: ONE fused
        gather launch plus ONE device->host copy of the staged blob,
        charged to this replica's clock — paid only when the broker has
        room.  With ``snapshot_page_bytes`` set the blob is split into
        content-addressed pages before the put; the room probe stays the
        conservative all-pages-new check (it runs before the readout)."""
        if self.mode != "hotmem":
            return False            # prefix-KV rows are a hotmem concept
        units = self.spec.blocks_per_partition
        if not self.broker.snapshot_room(prof_name, units):
            return False
        with span("snapshot.capture", rid=rid, row=row) as s:
            ok = self._capture(prof_name, rid, row, units)
            if s:
                s.note(d2h_bytes=self._snapshot_layout().row_bytes, put=ok)
        return ok

    def _capture(self, prof_name: str, rid: str, row: int,
                 units: int) -> bool:
        layout = self._snapshot_layout()
        t0 = time.perf_counter()
        dev_blob = M.cache_read_rows(self.caches, [row], layout=layout)
        # numpy has no bf16: the host copy is the blob's raw bytes
        blob_u8 = dev_blob.view(torch.uint8).reshape(-1).cpu().numpy()
        wall = time.perf_counter() - t0
        nbytes = blob_u8.nbytes                      # == sum of leaf nbytes
        treedef = M.cache_flat_axes(self.caches)[2]
        metas = tuple((s.block_shape, layout.dtype) for s in layout.slots)
        pages = None
        if self.snapshot_page_bytes is not None:
            payload: Any = ("paged", treedef, metas)
            pages = self._paginate(blob_u8, units)
        else:
            payload = StagedRow(blob=blob_u8, treedef=treedef, metas=metas)
        ok = self.broker.snapshot_put(
            prof_name, units=units, payload=payload,
            tokens=self._prof_tokens.get(prof_name, 0), nbytes=nbytes,
            replica_id=self.replica_id, pages=pages)
        if ok:
            if pages is not None:
                self._mapped.update(d for d, _u, _b, _p in pages)
                self._index_device_pages(dev_blob, pages)
            self.now += wall
            self.events.append(StepEvent(self.now, "snapshot", wall,
                                         {"key": prof_name, "rid": rid,
                                          "bytes": nbytes, "row": row}))
        return ok

    def _paginate(self, blob_u8: np.ndarray, units: int) -> list:
        return paginate_blob(blob_u8, units, self.snapshot_page_bytes,
                             self._n_dev)

    def _reassemble(self, payload, specs: list) -> np.ndarray:
        """Rebuild the staged row blob from a paged entry: ONE contiguous
        host buffer assembled from the pages (``assemble_pages``)."""
        kind, _treedef, metas = payload
        assert kind == "paged", kind
        blob = assemble_pages(specs)
        want = sum(int(np.prod(s)) * getattr(torch, d).itemsize
                   for s, d in metas)
        assert blob.nbytes == want, (blob.nbytes, want)
        return blob

    def _recycle_idle(self) -> None:
        """Recycle idle containers past keep-alive: release their
        partitions (this is what makes memory reclaimable).  Each expiring
        container's partition is first offered to the host snapshot
        pool."""
        for prof, entries in list(self.warm.items()):
            fresh = [e for e in entries
                     if self.now - e[0] < self.keep_alive]
            expired = [e for e in entries
                       if self.now - e[0] >= self.keep_alive]
            if expired and not self._reclaim_orders \
                    and not self.broker.snapshot_restorable(prof):
                # capture at most ONE expiring container per profile, skip
                # when the pool already holds a restorable copy, and never
                # mid-order-drain (see the JAX package's engine for why)
                t, rid, row = max(expired)       # newest expiring entry
                self._offer_snapshot(prof, rid, row)
            for (_, rid, _row) in expired:
                self.arena.finish(rid)
            self.warm[prof] = fresh

    def _resize(self) -> None:
        if self.mode == "static":
            return
        demand = len(self.active) + sum(map(len, self.warm.values())) \
            + len(self.pending) + self.headroom
        tgt = target_bucket(self.ladder, max(demand, self.ladder[0]))
        cur = self._units()
        if tgt > cur:
            if self._reclaim_orders:
                # the host ordered this VM to shrink; plugging now would
                # ping-pong the same units between replicas
                return
            # units already in flight on open grants must not be
            # re-requested (grants account in broker blocks)
            owed = sum(g.pending + g.available for g in self._open_grants) \
                // self.spec.blocks_per_partition
            k = tgt - cur - owed
            if k <= 0:
                return
            self._grow_and_sync(self._of_parts(k), via_gate=True)
        elif tgt < cur:
            k = cur - tgt
            if self.mode == "hotmem" and \
                    not self.arena.manager.shrink_plan(k):
                return                       # nothing reclaimable yet
            self._unplug_now(self._of_parts(k))

    def _of_parts(self, parts: int) -> int:
        """``parts`` partitions in native units."""
        return parts * self.spec.blocks_per_partition // self._bpu

    def _grow_and_sync(self, native: int, *, via_gate: bool,
                       detail: Optional[dict] = None) -> int:
        """Grow the arena (through the host gate, or absorbing an
        already-claimed grant fill) + row sync + virtual-clock charge +
        event log.  Returns native units actually added."""
        with span("plug", units=native, rows=self._rows()) as s:
            mem = self._allocator() if s else None
            added = self._plug(native, via_gate, detail)
            if s:
                s.note(added=added, rows_after=self._rows())
                self._note_allocator(s, mem)
        return added

    def _plug(self, native: int, via_gate: bool,
              detail: Optional[dict]) -> int:
        before = self.arena.units()
        # absorb path: the claimed fill is a whole stripe (claim_grant only
        # releases coherent units); hotmem's native unit is a partition,
        # which stripes wholly, so only vanilla's block granules need the
        # stripe check — and vanilla is asserted off for sharded hosts.
        wall = self.arena.plug(native) if via_gate \
            else self.arena.absorb(
                native, shards=self._n_dev if self.mode == "vanilla" else 1)
        added = self.arena.units() - before
        if added:
            t0 = time.perf_counter()
            self._sync_rows(self._units())
            self._sync()
            wall += time.perf_counter() - t0
            self.now += wall
            self.events.append(StepEvent(self.now, "plug", wall,
                                         {"units": added, **(detail or {})}))
        return added

    def _unplug_now(self, units: int, *, stolen: bool = False
                    ) -> ReclaimEvent:
        """Unplug + row sync + virtual-clock charge + event log — shared by
        self-initiated shrink and broker-initiated steals (which do their
        own host accounting, hence ``notify_host=False``)."""
        with span("unplug", units=units, rows=self._rows(),
                  stolen=stolen) as s:
            mem = self._allocator() if s else None
            ev = self._unplug(units, stolen)
            if s:
                s.note(rows_after=self._rows(),
                       reclaimed_bytes=ev.reclaimed_bytes,
                       migrated_bytes=ev.migrated_bytes)
                self._note_allocator(s, mem)
        return ev

    def _unplug(self, units: int, stolen: bool) -> ReclaimEvent:
        ev = self.arena.unplug(units, notify_host=not stolen)
        t0 = time.perf_counter()
        self._sync_rows(self._units())
        self._sync()
        ev.wall_seconds += time.perf_counter() - t0
        self.now += ev.wall_seconds
        detail = {"reclaimed_bytes": ev.reclaimed_bytes,
                  "migrated_bytes": ev.migrated_bytes}
        if stolen:
            detail["stolen"] = True
        self.events.append(StepEvent(self.now, "unplug", ev.wall_seconds,
                                     detail))
        return ev

    def _sync_rows(self, parts: int) -> None:
        """Match the model-facing row cache to the arena partition count.
        Both directions copy into fresh storage, so a shrink frees the
        dropped rows' device memory.  Vanilla's row view stays full-size
        (its pool resizes in the arena)."""
        if self.mode == "vanilla":
            return
        rows = self._rows()
        if parts == rows:
            return
        if parts > rows:
            self.caches = M.cache_grow_rows(self.caches, parts)
        else:
            self.caches = M.cache_slice_rows(self.caches, parts)

    # ------------------------------------------------------- broker victim
    def load(self) -> int:
        """In-flight + queued invocations (the broker's idleness signal)."""
        return len(self.active) + len(self.pending)

    def _free_units(self) -> int:
        if self.mode == "vanilla":
            return self.arena.manager.free_blocks \
                // self.spec.blocks_per_partition
        return self.arena.manager.free_partitions

    def _evict_warm_suffix(self, k_parts: int) -> None:
        """HotMem shrink drops only a *free suffix* of the arena: extend
        that suffix by recycling warm (idle) containers sitting on its
        high rows, stopping at the first active row.  No snapshot capture
        here: this only runs under host pressure (capture rides the
        keep-alive expiry path)."""
        mgr = self.arena.manager
        warm_rows = {row: (t, prof, rid)
                     for prof, es in self.warm.items()
                     for (t, rid, row) in es}
        free = set(mgr._free)
        need, p = k_parts, mgr.plugged - 1
        while p >= 0 and need > 0:
            if p in free:
                need -= 1
            elif p in warm_rows:
                t, prof, rid = warm_rows[p]
                self.arena.finish(rid)
                self.warm[prof].remove((t, rid, p))
                need -= 1
            else:
                break                      # active row blocks the suffix
            p -= 1

    # -------------------------------------------------- async host pipeline
    def host_work(self) -> bool:
        """Open async-pipeline work: reclaim orders to drain (as victim) or
        grant fills to claim (as requester)."""
        return bool(self._reclaim_orders) or bool(self._open_grants)

    def _service_reclaim_orders(self) -> None:
        """Drain the pending-unplug queue incrementally: at most
        ``drain_parts_per_tick`` partitions per tick, fencing high rows via
        ``_evict_warm_suffix`` before each partial unplug."""
        q = self._reclaim_orders
        while q and not q[0].open:
            q.popleft()                  # filled naturally or canceled
        if not q:
            return
        order = q[0]
        chunk = min(self.drain_parts_per_tick
                    * self.spec.blocks_per_partition, order.remaining)
        freed, ev = self.reclaim_for_broker(chunk)
        if freed:
            shards = getattr(order, "shards", 1)
            if shards > 1:
                # sharded host: each freed partition stripes one slab per
                # device, so the fill lands shard-by-shard
                per = freed // shards
                accepted = sum(
                    self.broker.fulfill_order(order.order_id, per,
                                              ev if d == 0 else None,
                                              shard=d)
                    for d in range(shards))
            else:
                accepted = self.broker.fulfill_order(order.order_id,
                                                     freed, ev)
            if freed > accepted:         # rounding excess: normal release
                self.broker.release_units(self.replica_id, freed - accepted)
            if not order.open:
                q.popleft()
        elif not self.active and not self.pending \
                and not any(self.warm.values()):
            # fully drained VM with nothing left to give: abandon the rest
            self.broker.cancel_order(order.order_id)
            q.popleft()

    def _claim_grants(self, abandon: bool = False) -> None:
        """Requester side of the async pipeline: absorb units that reclaim
        orders drained into our open grants since the last tick.  With
        ``abandon`` (the engine is fully idle), pending remainders are
        canceled so victims stop draining for us."""
        if not self._open_grants:
            return
        for g in list(self._open_grants):
            got = self.broker.claim_grant(g)
            if got:
                self._grow_and_sync(self._native(got), via_gate=False,
                                    detail={"async_fill": True})
            if abandon and not g.done:
                self.broker.abandon_grant(g)
            if g.done and g.available == 0 \
                    and getattr(g, "incoherent", 0) == 0:
                self._open_grants.remove(g)

    def reclaim_for_broker(self, k_blocks: int
                           ) -> tuple[int, Optional[ReclaimEvent]]:
        """Victim side of a host steal: the broker needs ``k_blocks`` back.
        Recycle idle warm containers (hotmem: the ones blocking the free
        suffix; vanilla: oldest-first until enough blocks are free), then
        unplug — charging this replica's clock with the reclaim stall
        (hotmem: metadata-only; vanilla: migration copies).  Returns
        (blocks actually freed, event)."""
        if self.mode == "static":
            return 0, None
        k_parts = -(-k_blocks // self.spec.blocks_per_partition)
        units = self._of_parts(k_parts)
        if self.mode == "hotmem":
            self._evict_warm_suffix(k_parts)
            if not self.arena.manager.shrink_plan(units):
                return 0, None
        else:
            entries = sorted((t, prof, rid, row)
                             for prof, es in self.warm.items()
                             for (t, rid, row) in es)
            for t, prof, rid, row in entries:
                if self._free_units() >= k_parts:
                    break
                self.arena.finish(rid)
                self.warm[prof].remove((t, rid, row))
            if self.arena.manager.shrink_plan(units)[0] == 0:
                return 0, None        # nothing reclaimable: skip the
                #                       zero-yield migration pass entirely
        ev = self._unplug_now(units, stolen=True)
        return ev.reclaimed_units * self._bpu, ev

    # ----------------------------------------------------------------- run
    def _tick(self, todo: deque) -> None:
        """One scheduler iteration: submit due arrivals, admit, decode (or
        let time pass), recycle idle containers, resize."""
        with span("tick", replica=self.replica_id, active=len(self.active),
                  pending=len(self.pending)):
            while todo and todo[0].submit_s <= self.now:
                self.submit(todo.popleft())
            with span("grants"):
                self._claim_grants(abandon=not todo and not self.active
                                   and not self.pending
                                   and not any(self.warm.values()))
            with span("orders"):
                self._service_reclaim_orders()
            if not self.active and not self.pending and todo:
                self.now = max(self.now, todo[0].submit_s)
                return
            with span("admit"):
                self._try_admit()
            if self._row_req:
                with span("decode"):
                    self._decode()
            elif self.pending:
                # stuck in waitqueue: let time pass so warm rows expire /
                # the next resize can plug
                self.now += 0.01
            elif not todo and not self.pending and not self.active:
                # drain: idle containers age out, triggering final unplugs
                self.now += self.keep_alive / 8
            with span("recycle"):
                self._recycle_idle()
            with span("resize"):
                self._resize()

    def run(self, requests: list[Request], max_virtual_s: float = 1e9):
        todo = deque(sorted(requests, key=lambda r: r.submit_s))
        while (todo or self.pending or self.active
               or any(self.warm.values()) or self.host_work()) \
                and self.now < max_virtual_s:
            self._tick(todo)
        return self.metrics()

    def metrics(self) -> dict[str, Any]:
        lat = [r.latency for r in self.done
               if r.latency is not None and r.state is State.DONE]
        reclaims = self.arena.manager.reclaim_events
        return {
            "completed": sum(r.state is State.DONE for r in self.done),
            "killed": sum(r.state is State.KILLED for r in self.done),
            "latency_p50": float(np.percentile(lat, 50)) if lat else None,
            "latency_p99": float(np.percentile(lat, 99)) if lat else None,
            "reclaim_events": len(reclaims),
            "reclaimed_bytes": sum(e.reclaimed_bytes for e in reclaims),
            "migrated_bytes": sum(e.migrated_bytes for e in reclaims),
            "reclaim_wall_s": sum(e.wall_seconds for e in reclaims),
            "decode_steps": sum(1 for e in self.events
                                if e.kind == "decode"),
            "cold_starts": self.cold_starts,
            "warm_starts": self.warm_starts,
            "restore_starts": self.restore_starts,
            "remote_restore_starts": self.remote_restore_starts,
            "snapshots_taken": sum(1 for e in self.events
                                   if e.kind == "snapshot"),
            "events": self.events,
        }
