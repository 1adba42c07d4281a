"""Manifest-committed, async checkpointing.

Adapted copy of ``repro.training.checkpoint``, with the same on-disk
format, so a checkpoint written by either package restores in the other:

  <dir>/step_<N>/  shard_<host>.npz  +  MANIFEST.json  (written last; a
  checkpoint without a manifest is incomplete and ignored by ``latest``).

Writes go to ``step_<N>.tmp``, then an atomic rename: a crash mid-save
never corrupts the restore path (restart always finds the newest
*complete* step).  npz cannot store bf16, so a bf16 leaf is saved as its
``uint16`` bits under a key ending in ``::bf16``; here the bits go through
torch's ``int16`` view, the JAX package reads them back with ``ml_dtypes``.

``save`` copies every leaf to host memory on the calling thread before the
writer starts, so an async save is not raced by the next step's in-place
update.  A DTensor leaf is gathered whole (``sharding.full_tensor``, a
collective: every rank calls ``save``), and the rank numbered
``process_index`` writes the file.  Restore is mesh-agnostic: leaves are
loaded on the host and distributed onto the *target* ``placements`` (a
tree of ``sharding.NamedSharding`` like the state, ``None`` for a plain
leaf), so a checkpoint taken on mesh A restores onto mesh B, or onto no
mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding import distribute, full_tensor


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _unflatten_into(template, flat: dict[str, torch.Tensor], prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}/{k}")
                for k, v in sorted(template.items())}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, flat, f"{prefix}/{i}")
            for i, v in enumerate(template))
    return flat[prefix]


def _encode(x) -> tuple[str, np.ndarray]:
    """A leaf (tensor, DTensor or numpy array) -> (key suffix, a host copy
    npz can store): bf16 as its uint16 bits with the ``::bf16`` marker."""
    x = full_tensor(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return "::bf16", x.view(torch.int16).numpy().view(np.uint16)
        return "", x.numpy()
    x = np.array(x, copy=True)
    if x.dtype.name == "bfloat16":
        return "::bf16", x.view(np.uint16)
    return "", x


def _decode(key: str, arr: np.ndarray) -> tuple[str, torch.Tensor]:
    if key.endswith("::bf16"):
        return key[:-6], torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16)
    return key, torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, state, *, process_index: int = 0,
         blocking: bool = True) -> threading.Thread:
    """Write one host's shard + manifest; async when blocking=False.  In
    a process group every rank gathers, and only the rank numbered
    ``process_index`` writes (the others' thread has nothing to do)."""
    arrays = {}
    for k, v in _flatten(state):
        suffix, enc = _encode(v)
        arrays[k + suffix] = enc
    writer = not dist.is_initialized() or dist.get_rank() == process_index

    def _write():
        if not writer:
            return
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{process_index}.npz"), **arrays)
        manifest = {"step": step, "time": time.time(),
                    "keys": sorted(arrays), "hosts": 1}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic commit

    t = threading.Thread(target=_write, daemon=True)
    t.start()
    if blocking:
        t.join()
    return t


def latest(ckpt_dir: str) -> Optional[int]:
    """Newest *complete* (manifest-committed) step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name, "MANIFEST.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, template, *, placements=None,
            device=None, process_index: int = 0):
    """Load into the template's structure as tensors, on ``device`` when
    given (else on the CPU); reshard onto ``placements`` when given (a
    tree like the template whose leaves are ``NamedSharding`` records or
    ``None``) — elastic mesh changes.  A leaf with a sharding lands on its
    mesh's device type, each rank holding its own block."""
    path = os.path.join(ckpt_dir, f"step_{step}",
                        f"shard_{process_index}.npz")
    with np.load(path) as z:
        flat = dict(_decode(k, z[k]) for k in z.files)
    if device is not None:
        flat = {k: v.to(device) for k, v in flat.items()}
    if placements is not None:
        for k, sh in _flatten(placements):
            if sh is not None:
                flat[k] = distribute(flat[k].to(sh.mesh.device_type), sh)
    return _unflatten_into(template, flat)
