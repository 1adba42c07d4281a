"""One run of one cell: set-up, and the measured window on the wall clock,
with what the metric readers and the check read from it.

The window drives the port's ``ServeEngine`` (``repro_torch``), one
scheduler iteration at a time, over one ``HostMemoryBroker``: the harness
hands each invocation to its replica's engine when it is due, sets each
engine's clock to the wall clock (seconds since the harness's origin) before
every iteration, and stamps due, first-token and every token time on
``time.perf_counter()`` after the iteration, whose device work ends in a
synchronise.  Every iteration is the engine's own ``_tick`` with no trace
of its own to submit, so it never takes the jump to a next arrival; its
other idle jumps (``keep_alive / 8`` while warm containers drain, 10 ms
while invocations wait for memory with none running) would carry the
engine's clock past the wall clock, and the run counts every iteration
after which one did: a mix that takes them cannot come out correct.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import Counter, deque
from pathlib import Path
from typing import Any, Optional

from squeeze_bench import traffic as T

ROOT = Path(__file__).resolve().parent
EMPTY: deque = deque()


# ---------------------------------------------------------------------------
# The cell, as data
# ---------------------------------------------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, bench_path: Path) -> tuple[dict, dict, dict]:
    """(workload entry, configuration file, traffic mix) of a cell named in
    ``BENCHMARK.json``."""
    bench = load_json(bench_path)
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in {bench_path}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(bench_path.parent / cfg_entry["file"])
    mix = load_json(ROOT / "traffic" / f"{wl['traffic']}.json")
    T.check_mix(mix)
    return wl, config, mix


def model_config(config: dict):
    """The port's ``ModelConfig`` for a configuration file: the registered
    architecture with every size the file states."""
    import dataclasses as dc
    from repro_torch.configs.base import get_config
    return dc.replace(get_config(config["arch"]), **config["model"])


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Rec:
    """One invocation, on the harness clock (seconds since the origin)."""
    req: Any
    rep: int
    due: float
    client: int = -1
    first: Optional[float] = None
    last: Optional[float] = None
    tokens: int = 0
    gaps: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class Replica:
    id: str
    engine: Any
    profiles: list
    live: list = dataclasses.field(default_factory=list)
    unplugs: list = dataclasses.field(default_factory=list)
    decodes: list = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# Set-up
# ---------------------------------------------------------------------------


class Cell:
    """Weights, broker and engines of one run, and the harness clock."""

    def __init__(self, config: dict, mix: dict, seed: int, device, *,
                 control: Optional[str] = None, traced: bool = False):
        import torch
        from repro_torch.cluster.host import HostMemoryBroker
        from repro_torch.core.arena import ArenaSpec
        from repro_torch.models import model as M
        from repro_torch.serving.engine import ServeEngine
        from repro_torch.serving.request import FunctionProfile
        from squeeze_bench import weights

        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.traced = traced
        self.profiling = False
        self.origin = time.perf_counter()
        self.cfg = model_config(config)
        self.seed, self.control = seed, control
        self.params = weights.draw(M.param_specs(self.cfg), seed,
                                   self.device)
        served = self.params
        if "experts" in weights.CONTROLS.get(control, ()):
            weights.round_experts_int8(self.params)
        if "projections" in weights.CONTROLS.get(control, ()):
            served = weights.quantize_int8(self.params)
        a = config["arena"]
        self.spec = ArenaSpec.from_model(self.cfg, a["partition_tokens"],
                                         a["n_partitions"], a["block_tokens"])
        bpp = self.spec.blocks_per_partition
        b = mix["broker"]
        self.broker = HostMemoryBroker(
            budget_units=b["budget_partitions"] * bpp,
            async_reclaim=b["async_reclaim"], clock=self.clock,
            snapshot_pool_units=b["snapshot_pool_partitions"] * bpp)
        self.reps = []
        for r in mix["replicas"]:
            profs = [FunctionProfile(
                f"{r.get('tenant', '')}{p['name']}", p["prompt_tokens"],
                p["decode_tokens"], p["max_tokens"],
                tenant=r.get("tenant", "")) for p in mix["profiles"]]
            eng = ServeEngine(self.cfg, served, self.spec, mode="hotmem",
                              keep_alive=mix["keep_alive_s"],
                              broker=self.broker, replica_id=r["id"])
            rep = Replica(r["id"], eng, profs)
            self._instrument(rep)
            self.reps.append(rep)
        self.M = M

    def clock(self) -> float:
        return time.perf_counter() - self.origin

    def reference_params(self) -> dict:
        """The weights the reference reads, once the program's state is
        freed: those drawn from the seed.  A control that rounded the
        experts in place has every leaf drawn again, into the same
        buffers."""
        from squeeze_bench import weights
        if "experts" in weights.CONTROLS.get(self.control, ()):
            weights.draw(self.M.param_specs(self.cfg), self.seed,
                         self.device, into=self.params)
        return self.params

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def _instrument(self, rep: Replica) -> None:
        """The harness's own spans around the engine's unplug (every run) and
        decode step (traced runs): host clock, and the device memory the
        allocator holds on either side of an unplug."""
        import torch
        eng, bpp = rep.engine, self.spec.bytes_per_partition
        unplug = eng._unplug_now

        def memory():
            if not self.cuda:
                return None, None
            return (torch.cuda.memory_allocated(self.device),
                    torch.cuda.memory_reserved(self.device))

        def timed_unplug(units, *, stolen=False):
            mem0, res0 = memory()
            rows0 = eng._rows()
            t0 = self.clock()
            ev = unplug(units, stolen=stolen)
            t1 = self.clock()
            rows1 = eng._rows()
            mem1, res1 = memory()
            rep.unplugs.append({
                "t": t0, "wall_s": t1 - t0, "rows": rows1,
                "dropped_bytes": (rows0 - rows1) * bpp,
                "reclaimed_bytes": ev.reclaimed_bytes,
                "migrated_bytes": ev.migrated_bytes,
                "freed_bytes": None if mem0 is None else mem0 - mem1,
                "reserved_bytes": (res0, res1)})
            return ev
        eng._unplug_now = timed_unplug
        if not self.traced:
            return
        decode = eng._decode

        def logged_decode():
            rows = eng._rows()
            pos = [req.position for req in eng._row_req.values()]
            t0 = self.clock()
            decode()
            rep.decodes.append({"t": t0, "wall_s": self.clock() - t0,
                                "rows": rows, "positions": pos,
                                "profiled": self.profiling})
        eng._decode = logged_decode

    def warm_up(self) -> None:
        """Every shape this cell's traffic runs, once, outside the window:
        one prefill per prompt length, one decode step per arena size of the
        ladder, every resize of the ladder, one snapshot capture and
        restore."""
        import torch
        M, cfg, T_ = self.M, self.cfg, self.spec.partition_tokens
        eng = self.reps[0].engine
        params = eng.params
        lengths = sorted({p.prompt_tokens for r in self.reps
                          for p in r.profiles})
        for n in lengths:
            row = M.init_caches(cfg, 1, T_, device=self.device)
            tok = torch.full((1, n), 7, dtype=torch.int32, device=self.device)
            M.prefill(cfg, params, {"tokens": tok}, row)
            del row
        # the allocator: every resize of the ladder, down then up, each
        # with the old and the new rows alive at once, as an unplug and a
        # plug hold them (fresh sizes of GBs cost milliseconds of cudaMalloc)
        caches = M.init_caches(cfg, eng.ladder[-1], T_, device=self.device)
        for rows in reversed(eng.ladder[:-1]):
            caches = M.cache_slice_rows(caches, rows)
        for rows in eng.ladder[1:]:
            caches = M.cache_grow_rows(caches, rows)
        del caches
        for rows in eng.ladder:
            caches = M.init_caches(cfg, rows, T_, device=self.device)
            tok = torch.zeros((rows, 1), dtype=torch.int32, device=self.device)
            pos = torch.full((rows,), 5, dtype=torch.int32, device=self.device)
            M.decode_step(cfg, params, tok, pos, caches)
            if rows == eng.ladder[0]:
                blob = M.cache_read_rows(caches, [0])
                blob = blob.cpu().to(self.device)
                M.cache_write_rows(caches, blob, [1])
            del caches
        self.sync()
        if self.traced and self.cuda:
            # the profiler's first start initialises CUPTI (seconds): pay
            # it here, not inside the window
            from squeeze_bench.trace import DeviceTrace
            tr = DeviceTrace(self.clock)
            tr.start()
            torch.ones(1, device=self.device).add_(1)
            tr.stop()
            tr.device_events()


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------


class Runner:
    def __init__(self, cell: Cell):
        self.cell = cell
        self.recs: list[Rec] = []
        self.clients: dict[int, tuple[int, int]] = {}
        self.n = 0
        self.ticks = 0
        self.clock_excess: list[float] = []
        self.tick_log: list[tuple[float, float, str]] = []
        self.trace = None

    # -- requests ------------------------------------------------------
    def submit(self, rep_i: int, prof_i: int, due: float,
               client: int = -1) -> Rec:
        from repro_torch.serving.request import Request
        rep = self.cell.reps[rep_i]
        req = Request(f"{rep.id}-{self.n}", rep.profiles[prof_i], due)
        self.n += 1
        rec = Rec(req, rep_i, due, client)
        rep.engine.submit(req)
        rep.live.append(rec)
        self.recs.append(rec)
        return rec

    def _account(self, rep: Replica, stamp: float) -> None:
        from repro_torch.serving.request import State
        live, rep.live = rep.live, []
        for rec in live:
            req = rec.req
            if req.admitted_s is not None:
                n = max(0, req.position - req.profile.prompt_tokens)
                if n > rec.tokens:
                    if rec.tokens == 0:
                        rec.first = stamp
                    else:
                        rec.gaps.append((stamp, stamp - rec.last))
                    rec.last = stamp
                    rec.tokens = n
            if req.state in (State.DONE, State.KILLED):
                rec.done = True
                if rec.client >= 0:       # closed loop: the next invocation
                    ri, pi = self.clients[rec.client]
                    self.submit(ri, pi, stamp, rec.client)
            else:
                rep.live.append(rec)

    # -- one scheduler iteration --------------------------------------
    def tick(self, rep: Replica) -> bool:
        eng = rep.engine
        t = self.cell.clock()
        eng.now = t
        n_ev = len(eng.events)
        busy = bool(eng.active or eng.pending)
        eng._tick(EMPTY)
        stamp = self.cell.clock()
        self.ticks += 1
        if eng.now > stamp:
            self.clock_excess.append(eng.now - stamp)
        self._account(rep, stamp)
        if self.trace is not None and self.cell.profiling \
                and len(eng.events) > n_ev:
            kinds = sorted({e.kind for e in eng.events[n_ev:]})
            self.tick_log.append((t, stamp, "tick: " + "+".join(kinds)))
        return busy

    def run(self, until: float, arrivals: Optional[deque] = None,
            stop=None, trace_at: Optional[tuple[float, float]] = None
            ) -> None:
        """Drive every replica until the clock reads ``until`` (or ``stop()``
        holds).  ``arrivals``: (due, replica, profile) on the harness clock.
        ``trace_at``: (start, seconds) of the profiled part."""
        cell = self.cell
        arrivals = arrivals if arrivals is not None else deque()
        while True:
            now = cell.clock()
            if now >= until or (stop is not None and stop()):
                break
            if trace_at is not None:
                if self.trace is None and now >= trace_at[0]:
                    from squeeze_bench.trace import DeviceTrace
                    self.trace = DeviceTrace(cell.clock)
                    self.trace.start()
                    cell.profiling = True
                elif cell.profiling and now >= self.trace.t0 + trace_at[1]:
                    self.trace.stop()
                    cell.profiling = False
            while arrivals and arrivals[0][0] <= now:
                due, ri, pi = arrivals.popleft()
                self.submit(ri, pi, due)
            busy = False
            for rep in cell.reps:
                busy |= self.tick(rep)
            if not busy:
                nxt = arrivals[0][0] if arrivals else until
                time.sleep(min(max(nxt - cell.clock(), 0.0), 0.002))
        if cell.profiling:
            self.trace.stop()
            cell.profiling = False


# ---------------------------------------------------------------------------
# A whole run
# ---------------------------------------------------------------------------


def capacity(config: dict, mix: dict) -> float:
    """The configuration's capacity in this mix's invocations per second:
    its measured warm decode rate (``capacity_tokens_per_s``, from its
    closed-loop cell) over the mix's mean output tokens per invocation."""
    cap = config.get("capacity_tokens_per_s")
    if not cap:
        raise SystemExit("the configuration states no measured capacity")
    shares = T.zipf_shares(len(mix["profiles"]), mix["popularity"]["zipf_s"])
    mean = sum(s * p["decode_tokens"] for s, p in zip(shares, mix["profiles"]))
    return float(cap) / mean


def execute(config: dict, mix: dict, *, seed: int, seconds: float,
            traced: bool, device, t_process: float,
            control: Optional[str] = None) -> dict:
    """Set up, run the window, reduce.  Returns the run's data: what the
    metric readers and the check read."""
    import torch
    cell = Cell(config, mix, seed, device, control=control, traced=traced)
    cell.warm_up()
    runner = Runner(cell)
    tw = mix["trace_window"]
    if mix["loop"] == "closed":
        for c, (ri, pi) in enumerate(T.closed_clients(mix)):
            runner.clients[c] = (ri, pi)
            runner.submit(ri, pi, cell.clock(), c)
        # set-up the traffic needs: every client's first start
        firsts = list(runner.recs)
        runner.run(float("inf"), stop=lambda: all(
            r.req.admitted_s is not None for r in firsts))
        arrivals = deque()
    else:
        sched = T.open_arrivals(mix, capacity(config, mix), seconds)
    cell.sync()
    if cell.cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
    t_open = cell.clock()
    setup_s = time.perf_counter() - t_process
    if mix["loop"] == "open":
        arrivals = deque((t_open + a.due_s, a.replica, a.profile)
                         for a in sched)
    counters0 = [_counters(r.engine) for r in cell.reps]
    ev0 = [len(r.engine.events) for r in cell.reps]
    n_unplug0 = [len(r.unplugs) for r in cell.reps]
    end = t_open + seconds
    trace_at = (t_open + tw["start_s"], tw["seconds"]) \
        if traced and cell.cuda else None
    runner.run(end, arrivals, trace_at=trace_at)
    t_close = cell.clock()
    cell.sync()
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.cuda else 0
    return {
        "cell": cell, "runner": runner, "seed": seed,
        "seconds": seconds, "t_open": t_open, "t_close": t_close,
        "end": end, "setup_s": setup_s, "memory_peak_bytes": peak,
        "counters": [_delta(c0, _counters(r.engine))
                     for c0, r in zip(counters0, cell.reps)],
        "events": [r.engine.events[i:] for i, r in zip(ev0, cell.reps)],
        "unplugs": [r.unplugs[i:] for i, r in zip(n_unplug0, cell.reps)],
        "model": config["model"], "row_bytes": cell.spec.bytes_per_partition,
        "trace": None if runner.trace is None else runner.trace.reduce(
            runner.tick_log),
    }


def _counters(eng) -> dict:
    return {"cold": eng.cold_starts, "warm": eng.warm_starts,
            "restore": eng.restore_starts}


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def window_recs(run: dict) -> list[Rec]:
    """Invocations due inside the window."""
    return [r for r in run["runner"].recs
            if run["t_open"] <= r.due < run["end"]]


def kinds(run: dict) -> Counter:
    return Counter(e.kind for evs in run["events"] for e in evs)
