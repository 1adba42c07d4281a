"""Split-count sweep of the two decode-attention kernels on the card.

Times ``partition_attention`` and ``paged_attention`` at full-width
qwen2-7b heads (T = 2048 slots a row, Hkv = 4, G = 7, Dh = 128, bf16; the
pool in blocks of 32) for several split counts passed to the kernels
directly, beside the count that ``partition_attention.splits_for`` picks.
Four position sets: eight rows random in [0, T) (the kernel table's case),
one row at T - 1, eight rows at positions <= 256, and the engine's 64 rows
as the saturated mix binds them (``attention_cases.engine_positions``: 8
rows a function, each at a position drawn uniformly in [prompt, prompt +
decode)).  Each time is the median of 20 runs between CUDA events, each
behind a 2 GiB read that flushes L2, beside the bound: the valid slots'
K/V read once at the HBM rate.  Then how many clusters of each split count, and how many
blocks an SM, the card holds at once, per dtype and head dim.

    python -m repro_torch.launch.attention_sweep

Prints one JSON line per (case, splits), one per case with the count
``splits_for`` picks, one per (dtype, head dim, splits) with the
occupancy, and the card's name and power limit; fails without a CUDA
device.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from repro_torch import roofline
from repro_torch.kernels import ops
from repro_torch.kernels import partition_attention as pa
from repro_torch.launch.attention_cases import ENGINE_ROWS, engine_positions
from repro_torch.launch.kernel_demo import scatter_to_pool

SPLITS = (1, 2, 3, 4, 5, 6, 8, 12, 16)
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
    t, hkv, g, dh = 2048, 4, 7, 128
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
               for s in ((ENGINE_ROWS, hkv, g, dh),
                         (ENGINE_ROWS, t, hkv, dh),
                         (ENGINE_ROWS, t, hkv, dh)))
    k_pool, v_pool, tables, _ = scatter_to_pool(k, v, 32, seed=5)
    positions = {
        "p8_random": torch.randint(0, t, (8,), generator=gen, device=dev,
                                   dtype=torch.int32),
        "p1_pos2047": torch.tensor([t - 1], dtype=torch.int32, device=dev),
        "p8_pos_le_256": torch.randint(0, 257, (8,), generator=gen,
                                       device=dev, dtype=torch.int32),
        "p64_saturated": torch.from_numpy(engine_positions(0)).to(dev)}
    flush = torch.ones(2 << 30, dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = dh ** -0.5
    item = q.element_size()
    none = torch.empty(0, dtype=torch.float32, device=dev)
    for name, pos in positions.items():
        rows = pos.shape[0]
        qr = q[:rows]
        out = torch.empty_like(qr)
        valid = int(torch.clamp(pos.long() + 1, 0, t).sum())
        nbytes = 2 * valid * hkv * dh * item + 2 * qr.numel() * item \
            + 4 * rows
        bound_s, bound_by = roofline.bound_seconds(
            nbytes, 4.0 * valid * hkv * g * dh)
        picked = pa.splits_for(ext, qr, t)
        print(json.dumps({"case": name, "rows": rows, "valid_slots": valid,
                          "longest": int(pos.max()) + 1,
                          "picked_splits": picked,
                          "split_tokens": pa.SPLIT_TOKENS,
                          "bound_ms": bound_s * 1e3, "bound_by": bound_by}),
              flush=True)
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
                              "partition_ms": part, "paged_ms": paged,
                              "partition_roofline_pct":
                                  100 * bound_s * 1e3 / part}),
                  flush=True)
    for dtype, head_dim in ((d, h) for d in ("bf16", "f32")
                            for h in (64, 128, 256)):
        for splits in SPLITS:
            clusters, per_sm = ext.partition_attention_occupancy(
                splits, head_dim, dtype == "bf16")
            print(json.dumps({"occupancy": f"partition_attention {dtype}",
                              "dh": head_dim, "splits": splits,
                              "clusters_at_once": clusters,
                              "blocks_at_once": clusters * splits,
                              "blocks_per_sm": per_sm, "sms": sms}),
                  flush=True)


if __name__ == "__main__":
    main()
