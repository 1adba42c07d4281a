"""Kernel-level view of the paper's insight: decode attention over
contiguous HotMem partitions against the vanilla paged layout, plus the
``kv_compact`` migration pass that HotMem never issues.

  PYTHONPATH=src python -m repro_torch.launch.kernel_demo [--device cpu]

Port of ``examples/kernel_demo.py`` (and of the layout contrast of
``benchmarks/figures.py::kernel_layout_cost``): one contiguous K/V is
scattered into a permuted block pool with its inverse block table, decoded
both ways, and two tail blocks are then compacted into the head.  It runs
on the CUDA device unless ``--device cpu``; on the card every step is one
of the hand-written kernels.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.kernels import ops


def scatter_to_pool(k, v, block_tokens: int, seed: int = 0):
    """Cut contiguous (P, T, Hkv, Dh) K/V rows into blocks of
    ``block_tokens`` and place the P * T / BT blocks in a pool in a seeded
    random order.  Returns (k_pool, v_pool, tables, perm): pool block ``i``
    holds row block ``perm[i]``, and ``tables`` (P, T / BT) int32 is the
    inverse map, so row ``p``'s logical block ``j`` is pool block
    ``tables[p, j]``."""
    p, t = k.shape[:2]
    assert t % block_tokens == 0, (t, block_tokens)
    nb = p * (t // block_tokens)
    perm = np.random.default_rng(seed).permutation(nb)
    idx = torch.from_numpy(perm).to(k.device)
    shape = (nb, block_tokens) + tuple(k.shape[2:])
    k_pool = k.reshape(shape)[idx].contiguous()
    v_pool = v.reshape(shape)[idx].contiguous()
    tables = torch.from_numpy(
        np.argsort(perm).reshape(p, t // block_tokens).astype(np.int32))
    return k_pool, v_pool, tables.to(k.device), perm


def layout_contrast(q, k, v, positions, *, block_tokens: int, seed: int = 0,
                    compact: int = 2) -> dict:
    """Decode the same K/V in both layouts and pay one migration pass.

    q (P, Hkv, G, Dh); k/v (P, T, Hkv, Dh) contiguous rows with every
    position < T (so the ring is linear and both layouts hold the same
    tokens); positions (P,) int32.  Runs ``partition_attention`` on the
    rows and ``paged_attention`` on the permuted pool (``scatter_to_pool``),
    then ``kv_compact`` of the pool's last ``compact`` blocks into its first
    ones, in place.  Returns the two outputs, their largest difference, the
    pool after the compaction and whether the moved blocks arrived."""
    assert int(positions.max()) < k.shape[1], "positions must be < T"
    k_pool, v_pool, tables, perm = scatter_to_pool(k, v, block_tokens,
                                                   seed)
    partition = ops.partition_attention(q, k, v, positions)
    paged = ops.paged_attention(q, k_pool, v_pool, tables, positions)
    nb = k_pool.shape[0]
    src = list(range(nb - 1, nb - 1 - compact, -1))
    dst = list(range(compact))
    ops.kv_compact((k_pool, v_pool), src, dst)
    rows = k.reshape((nb, block_tokens) + tuple(k.shape[2:]))
    moved = all(torch.equal(k_pool[d], rows[int(perm[s])])
                for s, d in zip(src, dst))
    return {"partition": partition, "paged": paged,
            "max_abs_diff": float((paged.float()
                                   - partition.float()).abs().max()),
            "k_pool": k_pool, "v_pool": v_pool, "tables": tables,
            "moves": list(zip(src, dst)), "compacted": moved}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dev = torch.device(a.device)
    rng = np.random.default_rng(0)
    p, t, hkv, g, dh, bt = 4, 256, 2, 4, 64, 64
    q = torch.from_numpy(rng.normal(size=(p, hkv, g, dh))).float().to(dev)
    k = torch.from_numpy(rng.normal(size=(p, t, hkv, dh))).float().to(dev)
    v = torch.from_numpy(rng.normal(size=(p, t, hkv, dh))).float().to(dev)
    pos = torch.tensor([255, 100, 30, 200], dtype=torch.int32, device=dev)
    res = layout_contrast(q, k, v, pos, block_tokens=bt)
    print(json.dumps({"device": str(dev),
                      "paged_vs_partition_max_abs_diff": res["max_abs_diff"],
                      "kv_compact_moves": res["moves"],
                      "compacted": res["compacted"],
                      "launches": dict(ops.LAUNCHES)}))
    assert res["max_abs_diff"] <= 2e-5 and res["compacted"]
    print("kernel demo OK")


if __name__ == "__main__":
    main()
