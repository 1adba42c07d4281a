"""Analysis-mode tracing switches.

``analysis_mode()`` retraces the model for roofline *accounting* rather than
execution: layer-group scans unroll (XLA's HloCostAnalysis counts while
bodies once, not x trip-count) and chunked-flash attention is swapped for
its plain equivalent (identical FLOPs, no inner scan).  The resulting
lowering is never executed or even compiled — ``lowered.cost_analysis()``
reads the unoptimized module.  Combined with depth extrapolation (lower at
1 and 2 groups, extend linearly — exact because groups are identical) this
gives artifact-derived FLOPs/bytes at full depth in seconds.
"""
from __future__ import annotations

import contextlib
import contextvars

_ANALYSIS = contextvars.ContextVar("analysis_mode", default=False)


@contextlib.contextmanager
def analysis_mode():
    tok = _ANALYSIS.set(True)
    try:
        yield
    finally:
        _ANALYSIS.reset(tok)


def is_analysis() -> bool:
    return _ANALYSIS.get()


def scan_unroll() -> bool | int:
    return True if _ANALYSIS.get() else 1
