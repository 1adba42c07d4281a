"""Mean wall of a decode step with the arena full (the engine's ``decode``
StepEvents)."""
from squeeze_bench.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "decode")
