"""Model FLOPs of the window's cold-start prefills (from the
configuration's sizes) over their walls at the bf16 peak."""
from squeeze_bench import costs
from squeeze_bench.metrics._common import events, prompt_of


def read(run):
    evs = events(run, "prefill")
    if not evs:
        return None
    prompt = prompt_of(run)
    flops = sum(costs.prefill_flops(run["model"], prompt[e.detail["rid"]])
                for e in evs)
    return 100.0 * flops / (sum(e.wall_s for e in evs) * costs.PEAK_BF16)
