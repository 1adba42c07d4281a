"""Fault-tolerant training: checkpoint, crash, resume.

  PYTHONPATH=src python -m repro_torch.launch.train_resume [--device cpu]

Twin of the JAX package's ``examples/train_resume.py``: reduced
tinyllama-1.1b trains 12 steps with a crash injected at step 8, then
resumes from the newest complete checkpoint and finishes.  It runs on the
CUDA device unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch.train import train
from repro_torch.training import checkpoint as ckpt


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        print("=== run 1: crash injected at step 8 ===")
        try:
            train("tinyllama-1.1b", steps=12, batch=2, seq=32, ckpt_dir=d,
                  ckpt_every=4, fail_at_step=8, log_every=4, device=a.device)
        except RuntimeError as e:
            print(f"crashed: {e}")
        print(f"latest complete checkpoint: step {ckpt.latest(d)}")
        print("=== run 2: --resume ===")
        _, losses = train("tinyllama-1.1b", steps=12, batch=2, seq=32,
                          ckpt_dir=d, ckpt_every=4, resume=True, log_every=4,
                          device=a.device)
        print(f"resumed and finished; final loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
