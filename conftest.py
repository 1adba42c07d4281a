"""Hooks for the whole test tree.

Tests that need a CUDA card carry the ``card`` marker, registered here for
every directory, and skip elsewhere."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
