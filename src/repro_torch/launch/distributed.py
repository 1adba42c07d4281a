"""Restart supervision and hedged dispatch (port of
``repro.launch.distributed``).

``run_with_restarts`` is the supervision loop a cluster agent wraps around
the trainer: bounded restarts, exponential backoff, resume always on.
``hedged_dispatch`` is the serving-side straggler hedge the scenario bank
(``repro_torch.cluster.scenarios``) uses.  Both are copies of the JAX
package's functions.  Multi-process bring-up (the JAX package's
``initialize``) is not here: it moves onto ``torch.distributed`` with the
sharding work (ROADMAP item 13).
"""
from __future__ import annotations

import time
from typing import Callable


def run_with_restarts(fn: Callable[[], None], *, max_restarts: int = 16,
                      backoff_s: float = 5.0) -> None:
    """Supervise ``fn`` (a --resume-capable trainer) through failures.
    Each restart resumes from the newest manifest-committed checkpoint;
    data cursors are step-indexed so no input state is lost."""
    attempt = 0
    while True:
        try:
            fn()
            return
        except KeyboardInterrupt:
            raise
        except Exception as e:                      # noqa: BLE001
            attempt += 1
            if attempt > max_restarts:
                raise
            wait = min(backoff_s * 2 ** (attempt - 1), 300.0)
            print(f"[supervise] attempt {attempt} failed ({e!r}); "
                  f"restarting in {wait:.0f}s")
            time.sleep(wait)


def hedged_dispatch(replicas, submit: Callable, *, deadline_s: float):
    """Straggler mitigation for serving (design contract, exercised in
    tests/test_serving_hedge.py): submit to the least-loaded replica and
    hedge to a second one if no first token arrives before ``deadline_s``
    (typically the fleet P99 TTFT).  Returns the chosen replica indices."""
    order = sorted(range(len(replicas)),
                   key=lambda i: replicas[i].load())
    primary = order[0]
    t = submit(primary)
    if t is not None and t <= deadline_s:
        return [primary]
    backup = order[1] if len(order) > 1 else primary
    submit(backup)
    return [primary, backup]
