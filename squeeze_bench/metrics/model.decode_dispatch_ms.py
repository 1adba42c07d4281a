"""Host time to enqueue one decode step: the mean ``decode.dispatch`` span
(``M.decode_step`` called, up to its return, every kernel enqueued) in the
traced window."""
from squeeze_bench.metrics._spans import in_window


def read(run):
    spans = in_window(run, "decode.dispatch")
    if not spans:
        return None
    return 1e3 * sum(b - a for _r, a, b in spans) / len(spans)
