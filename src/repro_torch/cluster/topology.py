"""Device topology: the mesh a host exposes to its memory-control plane.

Squeezy segregates hotplugged memory into regions with bounded allocation
lifetimes; on real jax_pallas serving hardware the natural region boundary
is the *device* — a replica's KV spreads across a mesh of accelerators,
each with its own HBM limit, and the host's broker must arbitrate
**per-device** budgets, not one flat pool.  ``DeviceTopology`` is the
pure-metadata description of that mesh: how many devices a host exposes
and how many memory units (blocks) each one holds.

The whole cluster layer treats ``devices=1`` as the exact legacy
configuration: a single-device topology's ledger/broker arithmetic is
bit-identical to the pre-topology scalar-budget code (the regression
tests pin this), which is what makes the per-device refactor a
specialization rather than a fork.

Production topologies come from a real JAX mesh via
``repro_torch.sharding.mesh_topology`` (device count = mesh size) or
``repro_torch.launch.mesh.make_host_topology`` (local devices); tests and the
scenario bank construct them directly with ``DeviceTopology.uniform``.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """Per-device unit budgets for one host's mesh.

    ``budgets[d]`` is device ``d``'s HBM budget in broker units (blocks).
    Replicas span the full mesh (one shard per device), so balanced unit
    flows move ``k // n_devices`` units on every device — the ledger
    asserts divisibility at the flow, keeping per-device conservation
    exact rather than approximate.
    """

    budgets: tuple[int, ...]

    def __post_init__(self):
        assert self.budgets, "a topology needs at least one device"
        assert all(isinstance(b, int) and b > 0 for b in self.budgets), \
            f"per-device budgets must be positive ints: {self.budgets}"

    @property
    def n_devices(self) -> int:
        return len(self.budgets)

    @property
    def total_units(self) -> int:
        return sum(self.budgets)

    @property
    def uniform_budget(self) -> bool:
        return len(set(self.budgets)) == 1

    @classmethod
    def single(cls, budget_units: int) -> "DeviceTopology":
        """The legacy one-flat-pool host: one device owning everything."""
        return cls(budgets=(budget_units,))

    @classmethod
    def uniform(cls, total_units: int, devices: int) -> "DeviceTopology":
        """Split ``total_units`` evenly over ``devices`` (must divide —
        an uneven split would make balanced flows impossible)."""
        assert devices >= 1 and total_units > 0
        assert total_units % devices == 0, \
            f"budget {total_units} does not stripe over {devices} devices"
        return cls(budgets=(total_units // devices,) * devices)

    def assert_balanced(self, units: int, what: str = "flow") -> int:
        """Balanced-flow guard: ``units`` must stripe evenly over the
        mesh.  Returns the per-device share."""
        assert units % self.n_devices == 0, \
            f"{what} of {units} units does not stripe over " \
            f"{self.n_devices} devices"
        return units // self.n_devices

    def report(self) -> dict[str, Any]:
        return {"devices": self.n_devices,
                "budgets": list(self.budgets),
                "total_units": self.total_units}
