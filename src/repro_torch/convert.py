"""Move the JAX package's parameter and cache trees into the port.

The trees arrive as numpy arrays (``jax.device_get`` of the JAX tree), so
this module needs no JAX.  numpy has no native bf16: a JAX bf16 leaf comes
out with the ``bfloat16`` extension dtype, whose bits go across through a
``uint16`` view and come back as ``torch.bfloat16``, bit for bit.  The tree
structure (dicts, tuples, lists) is kept, so the port's ``tree_flatten``
orders the leaves as ``jax.tree.flatten`` does.
"""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(x: np.ndarray, device="cuda") -> torch.Tensor:
    x = np.array(x, order="C")          # a writable copy the tensor owns
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def tree_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays -> the same tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(np.asarray(tree), device)
