"""Helpers the per-layer readers share.  A reader is ``metrics/<name>.py``
with ``read(run) -> float | None``; ``run`` is what ``harness.execute``
returns.  A reader that finds nothing to read returns None, and the metric
is left out of the run's line."""
from __future__ import annotations

GIB = float(2 ** 30)


def events(run: dict, kind: str) -> list:
    """The engines' ``StepEvent``s of ``kind`` that ended in the window."""
    lo, hi = run["t_open"], run["end"]
    return [e for evs in run["events"] for e in evs
            if e.kind == kind and lo <= e.t <= hi]


def mean_ms(run: dict, kind: str):
    evs = events(run, kind)
    return 1e3 * sum(e.wall_s for e in evs) / len(evs) if evs else None


def ms_per_gib(run: dict, kind: str):
    evs = events(run, kind)
    nbytes = sum(e.detail.get("bytes", 0) for e in evs)
    return 1e3 * sum(e.wall_s for e in evs) / (nbytes / GIB) \
        if nbytes else None


def prompt_of(run: dict) -> dict:
    return {r.req.rid: r.req.profile.prompt_tokens
            for r in run["runner"].recs}


def kernel(run: dict, match):
    """(launches, device seconds) of the traced kernels whose short name
    ``match`` accepts, or None without a trace or a launch."""
    tr = run["trace"]
    if tr is None:
        return None
    n = s = 0
    for name, (c, sec) in tr["kernels"].items():
        if match(name):
            n += c
            s += sec
    return (n, s) if n else None


def decodes(run: dict, profiled_only: bool) -> list:
    lo, hi = run["t_open"], run["end"]
    return [d for rep in run["cell"].reps for d in rep.decodes
            if lo <= d["t"] < hi and (d["profiled"] or not profiled_only)]
