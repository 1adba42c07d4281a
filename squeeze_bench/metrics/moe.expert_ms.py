"""Device time of a decode step's expert blocks: the mean ``expert_ms`` of
the ``decode.moe`` spans in the traced window (the port's timing events
around each expert block, summed over the step's blocks).  A program
without such spans, or without their device times, gives nothing to
read."""
from squeeze_bench.metrics._spans import in_window


def read(run):
    ms = [r.attrs["expert_ms"] for r, _a, _b in in_window(run, "decode.moe")
          if "expert_ms" in r.attrs]
    return sum(ms) / len(ms) if ms else None
