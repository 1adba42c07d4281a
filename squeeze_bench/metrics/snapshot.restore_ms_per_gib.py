"""Snapshot restore wall (one host-to-device copy of the staged row and one
``snapshot_restore`` launch, synchronised) per GiB restored."""
from squeeze_bench.metrics._common import ms_per_gib


def read(run):
    return ms_per_gib(run, "restore")
