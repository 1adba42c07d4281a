#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 squeeze_bench/run.py --workload qwen2-7b.saturated --seed 7 \
        --seconds 51 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``src/repro_torch``), on a machine with the CUDA devices the cell
asks for.  ``--trace 1`` reports the cell's per-layer metrics (a
``torch.profiler`` trace of the mix's ``trace_window``) instead of its
end-to-end ones.  The last line of standard output is one JSON object;
the numbers that decide ``correct`` end standard error, each beside its
limit or floor.  Exit codes: 0 a result was printed; 2 bad arguments or
files, or a configuration whose sizes, as the program runs them, its
plain reference does not cover, or that leaves out a limit its reference
asks for (decided before set-up); 3 no CUDA device, or too few; 4 JAX or
the JAX package was loaded.

``--control int8`` (not part of the cell) serves the port's int8 weight
path instead of bf16: the control the shared limits were set against.
``--control int8x`` serves the same with every expert matrix rounded to
int8's per-output-channel grid too (kept in bf16), and ``--control int8e``
the experts so rounded with every other weight in bf16: the controls of an
expert model's own limit (``expert_kv_err``), which the shared limits do
not see under ``int8e``.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("int8", "int8x", "int8e"),
                    default=None)
    return ap.parse_args(argv)


def pin_hash_seed(seed: int) -> None:
    """The engine's prompt is ``hash(name) % 97 + 1``, and ``str`` hashes
    are salted per process: run under a hash seed drawn from ``--seed`` so
    the same seed gives the same prompts."""
    want = str(seed % (2 ** 32))
    if os.environ.get("PYTHONHASHSEED") != want:
        env = dict(os.environ, PYTHONHASHSEED=want)
        os.execve(sys.executable, [sys.executable] + sys.argv, env)


def pin_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernel build goes to ``build/torch_kernels``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "squeeze_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The metric entries this run reports: the cell's end-to-end metrics,
    or with a trace its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in moved]


def _quantiles(x: list) -> dict:
    """Count, median and upper percentiles of a sample (diagnostics)."""
    import numpy as np
    if not x:
        return {"n": 0}
    q = np.percentile(x, [50, 90, 95, 99])
    return {"n": len(x), "p50": round(float(q[0]), 2),
            "p90": round(float(q[1]), 2), "p95": round(float(q[2]), 2),
            "p99": round(float(q[3]), 2), "max": round(float(max(x)), 2)}


def main(argv=None) -> int:
    args = parse(argv)
    pin_hash_seed(args.seed)
    pin_caches()
    bench_path = ROOT / "BENCHMARK.json"
    if not bench_path.exists() or not (ROOT / "src" / "repro_torch").exists():
        print("run from a checkout with BENCHMARK.json and src/repro_torch",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from squeeze_bench import check, e2e, harness
    bench = json.loads(bench_path.read_text())
    wl, config, mix = harness.load_cell(args.workload, bench_path)
    try:
        reference = check.reference(config)
    except ValueError as e:
        print(f"{args.workload}: {e}", file=sys.stderr)
        return 2
    sizes = check.sizes(config)
    limits = check.limits(config, reference)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    run = harness.execute(config, mix, seed=args.seed, seconds=args.seconds,
                          traced=bool(args.trace), device="cuda:0",
                          t_process=T_PROCESS, control=args.control)

    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        try:
            v = e2e.read(run, m["name"])
        except KeyError:
            v = load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # correctness: judged rows copied out, the program's state freed, then
    # the reference
    numbers = check.bookkeeping(run)
    items = check.collect(run)
    cell = run["cell"]
    for rep in cell.reps:
        rep.engine = None
    cell.broker = None
    torch.cuda.synchronize()
    dtype = getattr(torch, config["dtype"])
    params = cell.reference_params()
    numbers.update(check.judge(
        run, items, lambda tok: reference.kv_cache(
            sizes, params, tok, dtype=dtype),
        at=check.layers(reference, sizes)))
    correct, shown = check.verdict(numbers, limits)

    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 4

    recs = harness.window_recs(run)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": wl["chips"],
              "memory_peak_bytes": int(run["memory_peak_bytes"])}
    out = {"correct": bool(correct), "attempted": len(recs),
           "failed": sum(1 for r in recs
                         if r.req.state.name == "KILLED"),
           "metrics": metrics, "device": device}
    tr = run["trace"]
    if args.trace and tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    c = run["counters"]
    info = {"completed": sum(r.done for r in recs),
            "starts": {k: sum(d[k] for d in c) for k in c[0]},
            "events": dict(harness.kinds(run)),
            "ticks": run["runner"].ticks,
            "ttft_ms_q": _quantiles(e2e.ttft_ms(run)),
            "itl_ms_q": _quantiles(e2e.itl_ms(run)),
            "unplugs": [[round(u["t"] - run["t_open"], 3),
                         round(1e3 * u["wall_s"], 3), u["reclaimed_bytes"],
                         u["rows"], u["reserved_bytes"]]
                        for us in run["unplugs"] for u in us],
            "longest_events": [
                [e.kind, round(e.t - run["t_open"], 3),
                 round(1e3 * e.wall_s, 3)]
                for e in sorted((e for evs in run["events"] for e in evs),
                                key=lambda e: -e.wall_s)[:8]],
            "kv_slot_err": numbers["kv_slot_err"],
            "kv_layers": numbers["kv_layers"],
            "judged_layers": numbers["judged_layers"],
            "window_close_late_s": run["t_close"] - run["end"]}
    print(json.dumps({"info": info}), file=sys.stderr)
    out["checks"] = shown
    for k, (v, lim) in shown.items():
        bound = "at least" if k in check.FLOORS else "limit"
        print(f"{k} {v} {bound} {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
