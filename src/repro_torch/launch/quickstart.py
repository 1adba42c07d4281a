"""Quickstart: build a model from the assigned pool, train a few steps,
then serve it through the partition arena (prefill + decode).

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--arch qwen2-7b] \\
      [--device cpu]

Twin of the JAX package's ``examples/quickstart.py``, on the reduced
config of the arch.  It runs on the CUDA device unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import get_config, list_archs, reduced
from repro_torch.models import model as M
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_step import (make_batch_labels,
                                             make_train_step)


def quickstart(arch: str, device="cuda") -> torch.Tensor:
    """Five train steps, then a 16-token prompt and 8 greedy tokens on
    two rows; returns the generated tokens (2, 24)."""
    cfg = reduced(get_config(arch))           # tiny same-family config
    print(f"arch={cfg.name} family={cfg.family} "
          f"full-size params={get_config(arch).param_count()/1e9:.2f}B")

    # --- train a few steps -------------------------------------------------
    params = M.init_params(cfg, 0, device=device)
    state = {"params": params, "opt": init_opt_state(params)}
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                         dtype=torch.int32).to(device)
    batch = make_batch_labels(toks)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((4, cfg.encoder_src_len, cfg.d_model),
                                      device=device)
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros(
            (4, cfg.vision_stub_tokens, cfg.d_model), device=device)
    for i in range(5):
        state, m = step(state, batch)
        print(f"train step {i}: loss={float(m['loss']):.4f}")

    # --- serve: prefill + decode through the partition arena ---------------
    caches = M.init_caches(cfg, 2, 64, device=device)
    prompt = toks[:2, :16]
    pb = {k: v[:2] for k, v in batch.items() if k != "labels"}
    pb["tokens"] = prompt
    with torch.no_grad():
        logits, caches = M.prefill(cfg, state["params"], pb, caches)
        out = [prompt]
        pos = torch.full((2,), 16, dtype=torch.int32, device=device)
        for i in range(8):
            nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out.append(nxt)
            logits, caches = M.decode_step(cfg, state["params"], nxt,
                                           pos + i, caches)
    gen_toks = torch.cat(out, dim=1)
    print(f"generated shapes: {tuple(gen_toks.shape)} "
          f"(prompt 16 + 8 new tokens)")
    return gen_toks


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=list_archs())
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    quickstart(a.arch, a.device)
    print("quickstart OK")


if __name__ == "__main__":
    main()
