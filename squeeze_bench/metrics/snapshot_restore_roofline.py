"""``snapshot_restore`` kernel time against its bound: each launch must
read the staged row once and write it once (2 x row bytes) at the HBM
rate; the kernel's device time comes from the trace."""
from squeeze_bench import costs
from squeeze_bench.metrics._common import kernel


def _restore(name):
    return "snapshot_kernel<" in name and "false>" in name


def read(run):
    k = kernel(run, _restore)
    if k is None:
        return None
    n, sec = k
    bound = n * costs.snapshot_restore_bytes(run["row_bytes"]) / costs.HBM_BW
    return 100.0 * bound / sec
