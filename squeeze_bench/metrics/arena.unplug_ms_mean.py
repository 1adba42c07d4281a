"""Mean wall of an unplug or steal: the hotmem manager's metadata, the kept
rows copied into fresh storage, synchronise (``ReclaimEvent.wall_seconds``,
as the engine's ``unplug`` StepEvents carry it)."""
from squeeze_bench.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "unplug")
