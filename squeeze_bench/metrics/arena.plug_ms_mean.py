"""Mean wall of a plug: grant, rows grown into fresh storage, synchronise
(the engine's ``plug`` StepEvents)."""
from squeeze_bench.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "plug")
