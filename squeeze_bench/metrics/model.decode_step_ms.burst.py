"""Mean wall of a decode step under bursty traffic (the engine's ``decode``
StepEvents: every arena row, one token each, synchronised)."""
from squeeze_bench.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "decode")
