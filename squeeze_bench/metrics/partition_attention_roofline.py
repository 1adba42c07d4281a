"""``partition_attention`` kernel time against its bound: per call, every
valid K/V slot of every row (position + 1 slots) read once, q read and the
output written once, at the HBM rate.  The rows' positions are logged
before each traced decode step; the kernel's device time comes from the
trace."""
from squeeze_bench import costs
from squeeze_bench.metrics._common import decodes, kernel


def read(run):
    k = kernel(run, lambda n: "partition_attention_kernel<" in n)
    steps = decodes(run, profiled_only=True)
    if k is None or not steps:
        return None
    model = run["model"]
    nbytes = model["num_layers"] * sum(
        costs.partition_attention_bytes(model, d["positions"], d["rows"])
        for d in steps)
    return 100.0 * nbytes / costs.HBM_BW / k[1]
