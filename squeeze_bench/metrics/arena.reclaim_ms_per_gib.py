"""The summed wall of every unplug or steal in the window (the harness's
span around the engine's unplug, which ends in a device synchronise) over
the GiB they returned: the paper's headline.  An unplug runs inside the
scheduler's iteration and holds every running invocation's next token."""
from squeeze_bench.e2e import reclaim_ms_per_gib


def read(run):
    return reclaim_ms_per_gib(run)
