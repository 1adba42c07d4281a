"""Model configurations (copies of ``repro.configs``)."""
