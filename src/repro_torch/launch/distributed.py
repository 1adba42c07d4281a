"""Multi-process bring-up, restart supervision and hedged dispatch (port
of ``repro.launch.distributed``).

``initialize`` brings up the default ``torch.distributed`` process group
from the same environment variables as the JAX package's (``nccl`` on the
card, ``gloo`` on the CPU); ``launch.mesh`` then lays its named dims over
the world.  ``run_with_restarts`` is the supervision loop a cluster agent
wraps around the trainer: bounded restarts, exponential backoff, resume
always on.  ``hedged_dispatch`` is the serving-side straggler hedge the
scenario bank (``repro_torch.cluster.scenarios``) uses.  Both are copies of
the JAX package's functions.
"""
from __future__ import annotations

import os
import time
from typing import Callable

import torch
import torch.distributed as dist


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: str = "cuda") -> tuple[int, int]:
    """``torch.distributed`` bring-up (no-op on one process).  Returns
    (rank, world_size): the existing group's when one is up, (0, 1) when
    there is neither a group nor a coordinator (``host:port``).  On the
    card each rank takes the local device of its rank."""
    coordinator = coordinator or os.environ.get("REPRO_COORDINATOR")
    if coordinator and not dist.is_initialized():
        world = num_processes \
            or int(os.environ.get("REPRO_NUM_PROCESSES", "1"))
        rank = process_id or int(os.environ.get("REPRO_PROCESS_ID", "0"))
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            init_method=f"tcp://{coordinator}", world_size=world, rank=rank)
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


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
