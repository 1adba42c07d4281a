"""Share of the traced window's decode steps replayed from a CUDA graph:
the ``decode.dispatch`` spans whose ``graph`` attribute is ``"replay"``, in
per cent of those that carry the attribute.  A program whose dispatch spans
carry none gives nothing to read."""
from squeeze_bench.metrics._spans import in_window


def read(run):
    modes = [r.attrs["graph"] for r, _a, _b in in_window(run,
                                                          "decode.dispatch")
             if "graph" in r.attrs]
    if not modes:
        return None
    return 100.0 * modes.count("replay") / len(modes)
