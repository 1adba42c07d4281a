"""Render the dry run's §Dry-run and §Roofline tables from its JSONL logs.

Port of ``repro.launch.report``:

  PYTHONPATH=src python -m repro_torch.launch.report \\
      --inputs dryrun_results.jsonl dryrun_multipod.jsonl

Later files win per (arch, shape, mesh) — fix re-runs supersede the sweep.
Every number in the tables is derived from shapes and the H100 SXM
data-sheet rates of ``repro_torch.roofline`` at 700 W; none is measured.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import HBM_PER_CHIP
from repro_torch.roofline import HBM_BW, LINK_BW, PEAK_BF16

GiB = 2 ** 30


def load(paths: list[str]) -> dict[tuple, dict]:
    cells: dict[tuple, dict] = {}
    for path in paths:
        try:
            with open(path) as f:
                for line in f:
                    try:
                        r = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    cells[(r["arch"], r["shape"], r["mesh"])] = r
        except FileNotFoundError:
            continue
    return cells


def _ms(x: float) -> str:
    return f"{x*1e3:.2f}"


def _lever(r: dict) -> str:
    rl = r["roofline"]
    coll = r.get("collectives", {}).get("bytes_by_op", {})
    top = max(coll, key=coll.get) if coll else ""
    if rl["bound"] == "collective":
        if "all-reduce" in top:
            return ("cut TP activation all-reduces (seq-shard between "
                    "attn/mlp, or trade model-axis for fsdp)")
        if "all-gather" in top:
            return "amortize/overlap FSDP weight gathers or drop fsdp axis"
        return f"reduce {top} volume"
    if rl["bound"] == "memory":
        if r["shape"].startswith("decode") or r["shape"] == "long_500k":
            return ("weight/cache bytes dominate: quantize weights or raise "
                    "batch to amortize reads")
        return "raise arithmetic intensity (fuse, larger microbatch)"
    return "near compute roofline: cut recompute/padding waste"


def render(cells: dict[tuple, dict]) -> tuple[str, str]:
    archs = sorted({a for a, _, _ in cells})
    shapes = [s for s in SHAPES]
    budget = HBM_PER_CHIP / 1e9

    # ---------------- §Dry-run -----------------
    dr = ["## §Dry-run\n",
          "Every (arch x shape) cell traced once on `meta` tensors over "
          "torch's fake process group on BOTH production meshes (16x16 "
          "single-pod, 256 ranks; 2x16x16 multi-pod, 512 ranks). "
          "`peak GiB` = the most that `MemTracker` saw held at once on one "
          "rank, the step's inputs included.  Budget: "
          f"{budget:.1f} GB/chip (NVIDIA H100 80GB HBM3, "
          "`torch.cuda.get_device_properties(0).total_memory`).\n",
          "| arch | shape | 16x16 | peak GiB | 2x16x16 | peak GiB | "
          "collectives (1-pod, /chip/step) |",
          "|---|---|---|---|---|---|---|"]
    for a in archs:
        for s in shapes:
            r1 = cells.get((a, s, "16x16"))
            r2 = cells.get((a, s, "2x16x16"))
            if r1 is None and r2 is None:
                continue

            def cell_str(r):
                if r is None:
                    return "—", ""
                if r.get("skipped"):
                    return "skip", "—"
                ok = "OK" if r.get("ok") else "FAIL"
                if not r.get("ok"):
                    return ok, "—"
                pk = r["memory"].get("peak_bytes", 0)
                fits = "" if r.get("fits_hbm") else " (!)"
                return ok, f"{pk/GiB:.2f}{fits}"

            s1, p1 = cell_str(r1)
            s2, p2 = cell_str(r2)
            collstr = ""
            if r1 and r1.get("ok") and not r1.get("skipped"):
                c = r1["collectives"]
                parts = [f"{k}={v/GiB:.2f}GiB" for k, v in
                         c["bytes_by_op"].items() if v > 0]
                collstr = " ".join(parts[:3])
            dr.append(f"| {a} | {s} | {s1} | {p1} | {s2} | {p2} | "
                      f"{collstr} |")
    n_ok = sum(1 for r in cells.values() if r.get("ok"))
    n_skip = sum(1 for r in cells.values() if r.get("skipped"))
    dr.append(f"\n**{n_ok}/{len(cells)} cells OK** ({n_skip} assigned "
              "long_500k skips for pure full-attention archs, as the "
              "reference skips them).\n")

    # ---------------- §Roofline -----------------
    ro = ["## §Roofline\n",
          "Per (arch x shape), single-pod 16x16 mesh (256 chips; "
          f"{PEAK_BF16/1e12:.0f} TFLOP/s bf16, {HBM_BW/1e12:.2f} TB/s HBM, "
          f"{LINK_BW/1e9:.0f} GB/s link/chip: the H100 SXM data-sheet "
          "rates at 700 W).  `compute/memory/coll` are the three roofline "
          "terms in ms (per-chip).  `useful` = MODEL_FLOPS / traced FLOPs "
          "(6·N·D train, 2·N_active·D inference).  `frac` = fraction of "
          "the compute roofline achieved at the modelled bound "
          "(useful-FLOPs time / max-term).\n",
          "| arch | shape | compute ms | memory ms | coll ms | bound | "
          "useful | frac | lever |",
          "|---|---|---|---|---|---|---|---|---|"]
    for a in archs:
        for s in shapes:
            r = cells.get((a, s, "16x16"))
            if not r or not r.get("ok") or r.get("skipped"):
                continue
            rl = r["roofline"]
            ro.append(
                f"| {a} | {s} | {_ms(rl['compute_s'])} | "
                f"{_ms(rl['memory_s'])} | {_ms(rl['collective_s'])} | "
                f"{rl['bound']} | {rl['useful_ratio']:.2f} | "
                f"{rl['roofline_fraction']:.3f} | {_lever(r)} |")
    return "\n".join(dr), "\n".join(ro)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--inputs", nargs="+",
                    default=["dryrun_results.jsonl", "dryrun_fixes.jsonl"])
    args = ap.parse_args()
    dr, ro = render(load(args.inputs))
    print(dr)
    print()
    print(ro)


if __name__ == "__main__":
    main()
