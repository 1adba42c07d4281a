"""Multi-pod dry run: trace every (architecture x shape) cell on the
production meshes and read the roofline's inputs from the trace.

Port of ``repro.launch.dryrun``.  Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape decode_32k [--multi-pod] [--out results.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Where the reference lowers and compiles each cell's step on 512
placeholder host devices, this runs the step once, eagerly, on ``meta``
tensors (shapes and placements only: nothing is computed or allocated)
over torch's fake process group of 256 or 512 ranks, whose collectives
return at once.  The group is process-wide: one world size a process, so
the CLI and the tests run it in a process of their own.  From that run:

  * the collectives: ``roofline.collective_bytes`` sees each one DTensor
    (or the model's own ``torch.distributed`` calls) issues on rank 0;
  * peak memory: ``MemTracker`` (``torch.distributed._tools``) follows
    every local block the step holds at once, its inputs included;
  * FLOPs: ``analysis_flops_bytes``, the unsharded step traced under
    ``FlopCounterMode`` at 1 and 2 layer groups and extended linearly;
  * HBM bytes: ``roofline.hbm_traffic_model``.

Each record keeps the reference's keys: ``lower_s`` times building the
mesh, the inputs and the step, ``compile_s`` the traced run, the
counterpart of the reference's compile.  The reference's
``f32_weight_upcast_bytes`` corrects an XLA-CPU artefact (f32 copies of
bf16 weights hoisted for the host's matmuls) that a torch trace does not
have, so there is nothing to subtract and ``memory.peak_bytes`` is the
estimate ``report`` reads.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any

import torch

from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.launch.specs import default_grad_accum, input_specs
from repro_torch.models.layers import tree_leaves
from repro_torch.roofline import (Roofline, collective_bytes, cost_analysis,
                                  cost_flops_bytes, hbm_traffic_model,
                                  model_flops_per_chip)
from repro_torch.sharding import (mesh_shape, serve_rules_for, sharding_ctx,
                                  train_rules_for)
from repro_torch.tracemode import analysis_mode

# torch.cuda.get_device_properties(0).total_memory of the NVIDIA H100
# 80GB HBM3 that chip_smoke.py runs on (its `analysis` line prints both)
HBM_PER_CHIP = 85_017_493_504


def production_mesh(multi_pod: bool):
    """The production mesh over torch's fake process group, brought up at
    the mesh's world size if this process has no group yet."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _mem_tracker():
    """A ``MemTracker`` that counts the local blocks only.  DTensor works
    out each new op's sharding by running it once on fake tensors of the
    global shape; those hold no memory, and torch 2.11's tracker counted
    them (up to 116 GiB on qwen2-7b's decode step), so every op run while
    a ``FakeTensorMode`` is on the dispatch stack is let through."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    class _Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(isinstance(m, FakeTensorMode)
                   for m in _get_current_dispatch_mode_stack()):
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)
    return _Tracker()


def _local_bytes(x: torch.Tensor) -> int:
    x = x.to_local() if hasattr(x, "to_local") else x
    return x.numel() * x.element_size()


def _memory_stats(tracker, argument_bytes: int) -> dict[str, float]:
    try:
        peak = sum(snap["Total"] for snap in
                   tracker.get_tracker_snapshot("peak").values())
        return {"argument_bytes": float(argument_bytes),
                "temp_bytes": float(peak - argument_bytes),
                "peak_bytes": float(peak)}
    except Exception as e:                      # tracker without support
        return {"error": repr(e)}


def trace_cell(arch, shape_name: str, *, multi_pod: bool = False,
               mesh="auto", cfg=None, grad_accum=None, rules=None,
               modes=None):
    """Build mesh + meta inputs and run the cell's step once, under
    ``sharding_ctx`` and the dispatch ``modes`` (by default
    ``collective_bytes`` and a ``MemTracker`` that holds the inputs).
    ``mesh=None`` runs unsharded (analysis mode); ``cfg`` may override
    the registry config (depth-reduced analysis traces).  Returns
    ((modes, meta), None), or (None, reason) for a skipped cell."""
    t0 = time.time()
    cfg = cfg or get_config(arch)
    cell = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return None, "skip: pure full-attention arch at 500k (DESIGN.md)"
    if mesh == "auto":
        mesh = production_mesh(multi_pod)

    from repro_torch.models import model as M
    if cell.kind == "train":
        from repro_torch.training.train_step import make_train_step
        rules = rules or (train_rules_for(cfg) if mesh is not None else {})
        accum = grad_accum or (default_grad_accum(cfg, cell, mesh, rules)
                               if mesh is not None else 1)
        specs = input_specs(cfg, shape_name, mesh, rules)
        step = make_train_step(cfg, grad_accum=accum)
        args = (specs["state"], specs["batch"])
    else:
        accum = 1
        rules = rules or (serve_rules_for(cfg, shape_name)
                          if mesh is not None else {})
        specs = input_specs(cfg, shape_name, mesh, rules)
        if cell.kind == "prefill":
            def step(params, batch, caches):
                return M.prefill(cfg, params, batch, caches)
            args = (specs["params"], specs["batch"], specs["caches"])
        else:
            def step(params, tokens, positions, caches):
                return M.decode_step(cfg, params, tokens, positions, caches)
            args = (specs["params"], specs["tokens"], specs["positions"],
                    specs["caches"])
    leaves = tree_leaves(list(args))
    if modes is None:
        tracker = _mem_tracker()
        tracker.track_external(*leaves)
        modes = (tracker, collective_bytes())
    t1 = time.time()
    with sharding_ctx(mesh, rules), \
            torch.set_grad_enabled(cell.kind == "train"), \
            contextlib.ExitStack() as stack:
        for m in modes:
            stack.enter_context(m)
        step(*args)
    return (modes, {"grad_accum": accum, "mesh": mesh, "rules": rules,
                    "argument_bytes": sum(_local_bytes(x) for x in leaves),
                    "lower_s": t1 - t0, "compile_s": time.time() - t1}), None


def analysis_flops_bytes(arch: str, shape_name: str,
                         n_chips: int) -> tuple[float, float]:
    """Per-chip (FLOPs, op bytes) via depth-extrapolated tracing: trace
    the unsharded step at 1 and 2 layer groups under ``analysis_mode``
    (the plain attention path: the same FLOPs as the chunked one, without
    its loops) and extend linearly to full depth — exact, since the
    groups are identical.  Train cells trace with grad_accum=1 (identical
    total math)."""
    cfg = get_config(arch)
    pat, tail = len(cfg.block_pattern), len(cfg.tail_pattern)
    vals = {}
    for k in (1, 2):
        cfg_k = dataclasses.replace(
            cfg, name=f"{cfg.name}@depth{k}", num_layers=pat * k + tail,
            encoder_layers=k if cfg.encoder_layers else 0)
        with analysis_mode(), cost_analysis() as cost:
            _, skip = trace_cell(arch, shape_name, mesh=None, cfg=cfg_k,
                                 grad_accum=1, modes=())
            assert not skip, skip
        vals[k] = cost_flops_bytes(cost)
    n = cfg.n_groups
    flops = vals[1][0] + (n - 1) * (vals[2][0] - vals[1][0])
    hbm = vals[1][1] + (n - 1) * (vals[2][1] - vals[1][1])
    return flops / n_chips, hbm / n_chips


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, tag: str = "", quant: bool = False,
             **trace_kwargs) -> dict[str, Any]:
    from repro_torch.models.layers import weight_quant
    cell = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "ok": False}
    if tag:
        rec["tag"] = tag
    t0 = time.time()
    try:
        with weight_quant() if quant else contextlib.nullcontext():
            out, skip = trace_cell(arch, shape_name, multi_pod=multi_pod,
                                   **trace_kwargs)
            if skip:
                rec.update(skipped=skip, ok=True)
                return rec
            (tracker, coll), meta = out
            rec["lower_s"] = round(meta["lower_s"], 1)
            rec["compile_s"] = round(meta["compile_s"], 1)
            cfg = get_config(arch)
            n_chips = math.prod(mesh_shape(meta["mesh"]).values())
            # FLOPs/bytes: the unsharded, depth-extrapolated analysis trace
            flops, op_bytes = analysis_flops_bytes(arch, shape_name,
                                                   n_chips)
            hbm = hbm_traffic_model(cfg, cell, meta["mesh"], meta["rules"],
                                    meta["grad_accum"])
        rec["op_bytes_accessed"] = op_bytes        # reference only
        summary = coll.summary()
        rl = Roofline(flops=flops, hbm_bytes=hbm,
                      coll_bytes=float(summary["total_bytes"]),
                      model_flops=model_flops_per_chip(
                          cfg, cell, n_chips, meta["grad_accum"]))
        rec.update(ok=True, grad_accum=meta["grad_accum"],
                   memory=_memory_stats(tracker, meta["argument_bytes"]),
                   collectives=summary, roofline=rl.as_dict())
        peak = rec["memory"].get("peak_bytes")
        rec["fits_hbm"] = bool(peak is not None and peak <= HBM_PER_CHIP)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK  "
                  f"peak={(peak or 0) / 2 ** 30:.2f} GiB  bound={rl.bound}  "
                  f"compute={rl.compute_s*1e3:.2f}ms  "
                  f"memory={rl.memory_s*1e3:.2f}ms  "
                  f"coll={rl.collective_s*1e3:.2f}ms  "
                  f"useful={rl.useful_ratio:.2f}", flush=True)
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
                  f"FAIL {rec['error']}", flush=True)
    finally:
        rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    args = ap.parse_args()

    done: set[tuple[str, str, str]] = set()
    if os.path.exists(args.out):                    # resume: skip OK cells
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    cells: list[tuple[str, str, bool]] = []
    if args.all:
        for arch in list_archs():
            for shape in SHAPES:
                cells.append((arch, shape, args.multi_pod))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells.append((args.arch, args.shape, args.multi_pod))

    for arch, shape, mp in cells:
        mesh_name = "2x16x16" if mp else "16x16"
        if (arch, shape, mesh_name) in done:
            print(f"[dryrun] {arch} x {shape} x {mesh_name}: cached OK")
            continue
        rec = run_cell(arch, shape, multi_pod=mp)
        rec.pop("traceback", None) if rec.get("ok") else None
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
