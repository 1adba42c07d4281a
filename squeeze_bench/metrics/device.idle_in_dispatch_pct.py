"""Share of the traced window in which the device is idle while the host is
inside a ``decode.dispatch`` span, at any depth below it
(``repro_torch.spans.idle_by_span`` over the trace's device operations,
their stamps' drift taken off: ``_spans.device_ops``)."""
from squeeze_bench.metrics._spans import (device_ops, in_window,
                                          program_spans, window)


def read(run):
    if not in_window(run, "decode.dispatch"):
        return None
    t0, t1 = window(run)
    idle = program_spans().idle_by_span(
        device_ops(run["runner"].trace), t0, t1, origin=run["cell"].origin)
    held = sum(s for path, s in idle.items()
               if "decode.dispatch" in path.split("/"))
    return 100.0 * held / (t1 - t0)
