"""The scheduler iteration's own host time: the mean over the traced
window's ``tick`` spans of the tick less its ``decode`` child (admission and
the start paths, recycling, resize, the order drain and the grant
claims)."""
from squeeze_bench.metrics._spans import in_window


def read(run):
    ticks = in_window(run, "tick")
    if not ticks:
        return None
    decode = {}
    for r, a, b in in_window(run, "decode"):
        decode[r.parent] = decode.get(r.parent, 0.0) + b - a
    return 1e3 * sum(b - a - decode.get(r.id, 0.0)
                     for r, a, b in ticks) / len(ticks)
