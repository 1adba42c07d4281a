"""Split-count sweep of the two decode-attention kernels on the card.

Times ``partition_attention`` and ``paged_attention`` at the shapes of
``chip_smoke.py`` (full-width qwen2-7b heads: P = 8 rows of T = 2048
slots, Hkv = 4, G = 7, Dh = 128, bf16; the pool in 512 blocks of 32) for
several split counts passed to the kernels directly, beside the count that
``partition_attention.num_splits`` picks.  Three position sets: random in
[0, T) (the kernel table's case), one row at T - 1, and eight rows at
positions <= 256 (the engine's range).  Each time is the median of 20
runs between CUDA events, each behind a 2 GiB read that flushes L2.

    python -m repro_torch.launch.attention_sweep

Prints one JSON line per (shape, splits) and the card's name and power
limit; fails without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import partition_attention as pa
from repro_torch.launch.kernel_demo import scatter_to_pool

SPLITS = (4, 6, 8, 12, 16)
RUNS = 20


def _median_ms(fn, flush) -> float:
    fn()
    times = []
    for _ in range(RUNS):
        flush.amax()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attention_sweep runs on an NVIDIA card only")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    ext = ops.load()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    p, t, hkv, g, dh = 8, 2048, 4, 7, 128
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
               for s in ((p, hkv, g, dh), (p, t, hkv, dh), (p, t, hkv, dh)))
    k_pool, v_pool, tables, _ = scatter_to_pool(k, v, 32, seed=5)
    positions = {
        "p8_random": torch.randint(0, t, (p,), generator=gen, device=dev,
                                   dtype=torch.int32),
        "p1_pos2047": torch.tensor([t - 1], dtype=torch.int32, device=dev),
        "p8_pos_le_256": torch.randint(0, 257, (p,), generator=gen,
                                       device=dev, dtype=torch.int32)}
    flush = torch.ones(2 << 30, dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = dh ** -0.5
    for name, pos in positions.items():
        rows = pos.shape[0]
        qr = q[:rows]
        out = torch.empty_like(qr)
        none = torch.empty(0, dtype=torch.float32, device=dev)
        picked = pa.num_splits(rows, hkv, g, t, sms)
        for splits in SPLITS:
            part = _median_ms(lambda s=splits: ext.partition_attention(
                qr, k[:rows], v[:rows], pos, out, none, none, s, scale, 0.0,
                0, 0, t, stream),
                flush)
            paged = _median_ms(lambda s=splits: ext.paged_attention(
                qr, k_pool, v_pool, tables[:rows], pos, out, s, scale, 0.0,
                stream), flush)
            print(json.dumps({"case": name, "splits": splits,
                              "picked": splits == picked,
                              "partition_ms": part, "paged_ms": paged}),
                  flush=True)


if __name__ == "__main__":
    main()
