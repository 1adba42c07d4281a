"""Perf hill-climb runner: the three selected cells, baseline vs each
hypothesis, through the port's dry run.

Port of ``repro.launch.hillclimb`` (the same experiments, tags, arches,
shapes, rules and grad_accum):

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --out hillclimb.jsonl
"""
import argparse
import json

from repro_torch.configs.base import get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.sharding import (DP_ONLY_TRAIN_RULES, TRAIN_RULES,
                                  train_rules_for)


def experiments():
    # ---- Cell A: dbrx-132b x train_4k (most collective-bound) ----------
    dbrx = get_config("dbrx-132b")
    yield ("dbrx-132b", "train_4k",
           dict(tag="A0-baseline", rules=dict(TRAIN_RULES, seq_remat=None),
                grad_accum=16))
    yield ("dbrx-132b", "train_4k",
           dict(tag="A1-seqremat-accum1",
                rules=train_rules_for(dbrx, dp_only=False)))
    yield ("dbrx-132b", "train_4k",
           dict(tag="A2-seqremat-accum4",
                rules=train_rules_for(dbrx, dp_only=False), grad_accum=4))
    # A3 (flash-train + accum1) was refuted in the reference's loop
    # A4: accum=8 — the fitting point on the gather-vs-activation frontier
    yield ("dbrx-132b", "train_4k",
           dict(tag="A4-seqremat-accum8",
                rules=train_rules_for(dbrx, dp_only=False), grad_accum=8))

    # ---- Cell B: tinyllama-1.1b x train_4k (worst train frac / TP
    #      all-reduce pathology, representative of all small-arch cells) --
    yield ("tinyllama-1.1b", "train_4k", dict(tag="B0-baseline",
                                              rules=TRAIN_RULES))
    yield ("tinyllama-1.1b", "train_4k", dict(tag="B1-dp-only",
                                              rules=DP_ONLY_TRAIN_RULES))

    # ---- Cell C: qwen2-7b x decode_32k (paper-representative: decode on
    #      the HotMem partition arena; memory-bound) ----------------------
    yield ("qwen2-7b", "decode_32k", dict(tag="C0-baseline"))
    yield ("qwen2-7b", "decode_32k", dict(tag="C1-int8-weights",
                                          quant=True))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="hillclimb.jsonl")
    ap.add_argument("--only", default=None)
    args = ap.parse_args()
    for arch, shape, kw in experiments():
        if args.only and args.only not in kw["tag"]:
            continue
        rec = run_cell(arch, shape, **kw)
        rec.pop("traceback", None)
        rl = rec.get("roofline", {})
        print(f"  -> {kw['tag']}: bound={rl.get('bound')} "
              f"compute={rl.get('compute_s', 0)*1e3:.1f}ms "
              f"memory={rl.get('memory_s', 0)*1e3:.1f}ms "
              f"coll={rl.get('collective_s', 0)*1e3:.1f}ms "
              f"frac={rl.get('roofline_fraction', 0):.4f}")
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
