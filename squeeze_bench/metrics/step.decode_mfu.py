"""Model FLOPs of the window's decode steps (the bound rows' tokens,
from the configuration's sizes and the positions logged before each step)
over the steps' walls at the bf16 peak."""
from squeeze_bench import costs
from squeeze_bench.metrics._common import decodes


def read(run):
    steps = decodes(run, profiled_only=False)
    if not steps:
        return None
    flops = sum(costs.decode_flops(run["model"], d["positions"])
                for d in steps)
    return 100.0 * flops / (sum(d["wall_s"] for d in steps)
                            * costs.PEAK_BF16)
