"""Serving launcher: trace-driven elastic serving on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --mode hotmem --duration 20 --rate 1.0 [--reduced] [--device cpu]

Port of ``repro.launch.serve``: runs the ServeEngine against a bursty
synthetic trace and prints the reclaim/latency metrics the paper's
Figs. 8–10 report.  It runs on the CUDA device unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import get_config, reduced
from repro_torch.core.arena import ArenaSpec
from repro_torch.models import model as M
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import PROFILES, Request
from repro_torch.serving.tracegen import assign_profiles, bursty_trace


def serve(arch: str, *, mode: str = "hotmem", duration: float = 20.0,
          rate: float = 1.0, n_partitions: int = 8,
          partition_tokens: int = 128, keep_alive: float = 3.0,
          use_reduced: bool = True, seed: int = 0, device="cuda"):
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    params = M.init_params(cfg, seed, device=device)
    spec = ArenaSpec.from_model(cfg, partition_tokens=partition_tokens,
                                n_partitions=n_partitions, block_tokens=32)
    arrivals = bursty_trace(duration, rate, burst_x=6.0, burst_at=(0.0,),
                            burst_len=duration / 6,
                            quiet_after=duration / 2, seed=seed)
    reqs = [Request(rid=f"r{i}", profile=p, submit_s=t)
            for i, (t, p) in enumerate(
                assign_profiles(arrivals, PROFILES, seed))]
    eng = ServeEngine(cfg, params, spec, mode=mode, keep_alive=keep_alive,
                      seed=seed)
    metrics = eng.run(reqs, max_virtual_s=duration * 40)
    return eng, metrics


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", default="hotmem", choices=["hotmem", "static"])
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--partition-tokens", type=int, default=128)
    ap.add_argument("--keep-alive", type=float, default=3.0)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    _, m = serve(a.arch, mode=a.mode, duration=a.duration, rate=a.rate,
                 n_partitions=a.partitions,
                 partition_tokens=a.partition_tokens,
                 keep_alive=a.keep_alive, use_reduced=a.reduced,
                 device=a.device)
    m.pop("events")
    print(json.dumps(m, indent=2, default=str))


if __name__ == "__main__":
    main()
