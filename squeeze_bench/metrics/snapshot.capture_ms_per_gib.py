"""Snapshot capture wall (one ``snapshot_capture`` launch and one
device-to-host copy of the staged row) per GiB captured."""
from squeeze_bench.metrics._common import ms_per_gib


def read(run):
    return ms_per_gib(run, "snapshot")
