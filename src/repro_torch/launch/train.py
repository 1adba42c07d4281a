"""Training launcher: any config, fault-tolerant, on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 50 --ckpt-dir CKPT --ckpt-every 10 [--resume] \\
      [--device cpu]

Port of ``repro.launch.train``.  Fault-tolerance contract:
  * checkpoints are manifest-committed (atomic rename) and async, with one
    save in flight at a time;
  * ``--resume`` restores the newest complete step, and the data pipeline
    cursor is a pure function of the step, so a restart is exact.
  * on a mesh, ``--resume`` restores onto the *current* mesh's placements
    (elastic rescale: a checkpoint from mesh A loads onto mesh B).
It runs on the CUDA device unless ``--device cpu``.  ``train(mesh=...)``
(a ``DeviceMesh`` from ``launch.mesh``, every rank calling ``train``) puts
the params, master, m and v on the mesh by ``train_rules_for(cfg)``, each
batch on ("batch", "seq"), and runs the step under ``sharding_ctx``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.models import model as M
from repro_torch.sharding import (distribute, full_tensor, named_sharding,
                                  sharding_ctx, train_rules_for)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, SyntheticTokens
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


def make_batch(cfg, data: SyntheticTokens, step: int, device) -> dict:
    """The batch of ``step`` on ``device``: tokens, next-token labels, and
    zero stub inputs for the audio (frames) and vlm (patches) families."""
    toks = data.batch_at(step)
    b = {"tokens": torch.from_numpy(toks).to(device),
         "labels": torch.from_numpy(data.labels_at(step, toks)).to(device)}
    batch = toks.shape[0]
    if cfg.family == "vlm":
        b["vision_embeds"] = torch.zeros(
            (batch, cfg.vision_stub_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=device)
    if cfg.family == "audio":
        b["frames"] = torch.zeros((batch, cfg.encoder_src_len, cfg.d_model),
                                  dtype=torch.bfloat16, device=device)
    return b


def state_shardings(cfg, mesh, rules) -> dict:
    """The train state's ``NamedSharding`` tree: master, m and v take the
    params' placements; the step counter stays a plain tensor."""
    ps = M.param_shardings(cfg, mesh, rules)
    return {"params": ps,
            "opt": {"step": None, "master": ps, "m": ps, "v": ps}}


def batch_to_mesh(batch: dict, mesh, rules) -> dict:
    """Each batch leaf distributed on ("batch", "seq", ...) over ``mesh``
    (every rank holds the whole batch, as every host builds it from the
    step's seed)."""
    return {k: distribute(v, named_sharding(
        ("batch", "seq") + (None,) * (v.ndim - 2), tuple(v.shape), mesh,
        rules)) for k, v in batch.items()}


def scalar(x) -> float:
    """A 0-d metric as a float (a DTensor's through its full value)."""
    return float(full_tensor(x))


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
          use_reduced: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 10, resume: bool = False, grad_accum: int = 1,
          lr: float = 3e-4, mesh=None, log_every: int = 10,
          fail_at_step: int | None = None, device="cuda"):
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    rules = train_rules_for(cfg) if mesh is not None else {}

    data = SyntheticTokens(DataConfig(cfg.vocab_size, seq, batch))
    params = M.init_params(cfg, 0, device=device, mesh=mesh, rules=rules)
    state = {"params": params, "opt": init_opt_state(params)}
    start_step = 0
    if resume and ckpt_dir and (last := ckpt.latest(ckpt_dir)) is not None:
        state = ckpt.restore(
            ckpt_dir, last, state, device=device, placements=None
            if mesh is None else state_shardings(cfg, mesh, rules))
        start_step = last
        print(f"[train] resumed from step {last}")

    step_fn = make_train_step(cfg, AdamWConfig(lr=lr), grad_accum=grad_accum)
    pending_save = None
    losses = []
    with sharding_ctx(mesh, rules):
        for step in range(start_step, steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            b = make_batch(cfg, data, step, device)
            if mesh is not None:
                b = batch_to_mesh(b, mesh, rules)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            loss = scalar(metrics["loss"])
            losses.append(loss)
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {scalar(metrics['grad_norm']):.3f} "
                      f"({(time.perf_counter()-t0)*1e3:.0f} ms)")
            if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()          # one in-flight save
                pending_save = ckpt.save(ckpt_dir, step + 1, state,
                                         blocking=False)
    if pending_save is not None:
        pending_save.join()
    return state, losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    _, losses = train(a.arch, steps=a.steps, batch=a.batch, seq=a.seq,
                      use_reduced=a.reduced, ckpt_dir=a.ckpt_dir,
                      ckpt_every=a.ckpt_every, resume=a.resume,
                      grad_accum=a.grad_accum, lr=a.lr, device=a.device)
    print(f"[train] done; loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
