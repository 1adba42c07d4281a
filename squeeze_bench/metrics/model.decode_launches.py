"""Device operations (kernels, copies, sets) a decode step puts on the
device: those that start inside a ``decode`` span (their stamps' drift
taken off: ``_spans.device_ops``), over the number of ``decode`` spans in
the traced window."""
import bisect

from squeeze_bench.metrics._spans import device_ops, in_window


def read(run):
    spans = sorted((a, b) for _r, a, b in in_window(run, "decode"))
    if not spans:
        return None
    starts = [a for a, _b in spans]
    n = 0
    for _name, a, _b in device_ops(run["runner"].trace):
        i = bisect.bisect_right(starts, a) - 1
        n += i >= 0 and a <= spans[i][1]
    return n / len(spans)
