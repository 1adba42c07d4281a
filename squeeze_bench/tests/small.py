"""A cell at a size the CPU runs in seconds: the port's qwen2-7b
architecture at reduced widths, an arena of 8 partitions of 64 tokens, and
mixes of the benchmark's shape over four short functions."""
from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

MODEL = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 512}


def config() -> dict:
    c = json.loads((HERE / "configs" / "qwen2-7b.json").read_text())
    c["model"].update(MODEL)
    c["arena"] = {"partition_tokens": 64, "n_partitions": 8,
                  "block_tokens": 16}
    c["capacity_tokens_per_s"] = 100.0
    return c


def mix(name: str) -> dict:
    m = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    m = copy.deepcopy(m)
    m["profiles"] = [{"name": f"fn{i}", "prompt_tokens": p,
                      "decode_tokens": d, "max_tokens": 64}
                     for i, (p, d) in enumerate(zip([8, 16, 24, 32],
                                                    [8, 6, 4, 2]))]
    m["broker"] = {"budget_partitions": 12, "snapshot_pool_partitions": 4,
                   "async_reclaim": m["broker"]["async_reclaim"]}
    if m["loop"] == "open":
        m["schedule"] = {"period_s": 1.5, "phases": [
            {"seconds": 0.5, "rate_share": 1.2},
            {"seconds": 1.0, "rate_share": 0.15}]}
        if m["keep_alive_s"]:
            m["keep_alive_s"] = 0.3
    else:
        m["clients_per_profile"] = 2
    return m
