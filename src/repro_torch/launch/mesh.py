"""Production and host meshes on ``torch.distributed``.

Port of ``repro.launch.mesh``.  Functions, not module-level constants:
importing this module touches no process group.  Each builds a
``DeviceMesh`` over the whole world of the default process group (which
``launch.distributed.initialize`` brings up), with named dims, on the
card unless the caller asks for the CPU (``device_type="cpu"``, gloo).
"""
from __future__ import annotations

import torch.distributed as dist


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {n} ranks, the process "
            f"group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(device_type="cuda"):
    """Degenerate 1 x n mesh over every rank of the world (tests,
    examples): (1, 1) on one card; (1, 2) for two gloo ranks sharing one
    card, where ``sharding.redistribute`` moves the DTensors (torch's
    functional all-gather dies under gloo on CUDA tensors)."""
    return _mesh((1, dist.get_world_size()), ("data", "model"), device_type)


def make_host_topology(budget_per_device: int):
    """The memory-control-plane view of THIS host's devices: a uniform
    ``DeviceTopology`` with ``budget_per_device`` broker units (blocks) of
    device-memory budget on each device of the host mesh (every rank of
    the world; this one device before ``initialize``).  Feed it to
    ``HostMemoryBroker`` so grants, reclaim and snapshots stripe over the
    real local mesh."""
    from repro_torch.cluster.topology import DeviceTopology

    assert budget_per_device > 0
    n = dist.get_world_size() if dist.is_initialized() else 1
    return DeviceTopology(budgets=(budget_per_device,) * n)
