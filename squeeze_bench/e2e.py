"""End-to-end metrics: taken by the harness itself on the host's wall clock,
over all the invocations of the window.

  ttft_p95_ms         95th percentile of the time from an invocation's due
                      time to its first token, whichever start path it took;
                      one still without a token at the close counts with
                      its age then
  itl_p99_ms          every gap between consecutive tokens of one
                      invocation, over all invocations; a gap still open at
                      the close counts with its length then
  tokens_per_s        tokens emitted in the window over its seconds
  setup_s             process start to the window's opening

and the reclaim wall per GiB that a per-layer reader takes from here: the
summed wall of every unplug or steal in the window (the harness's span
around the engine's unplug, which ends in a device synchronise) over the
GiB they returned.
"""
from __future__ import annotations

import numpy as np

GIB = float(2 ** 30)


def ttft_ms(run: dict) -> list[float]:
    lo, hi = run["t_open"], run["end"]
    return [1e3 * ((r.first if r.first is not None else hi) - r.due)
            for r in run["runner"].recs if lo <= r.due < hi]


def itl_ms(run: dict) -> list[float]:
    lo, hi = run["t_open"], run["end"]
    out = []
    for r in run["runner"].recs:
        out += [1e3 * g for t, g in r.gaps if lo <= t < hi]
        if r.last is not None and not r.done and r.last < hi:
            out.append(1e3 * (hi - r.last))
    return out


def tokens_in_window(run: dict) -> int:
    lo, hi = run["t_open"], run["end"]
    n = 0
    for r in run["runner"].recs:
        if r.first is not None and lo <= r.first < hi:
            n += 1
        n += sum(1 for t, _ in r.gaps if lo <= t < hi)
    return n


def reclaim_ms_per_gib(run: dict):
    lo, hi = run["t_open"], run["end"]
    us = [u for ups in run["unplugs"] for u in ups if lo <= u["t"] < hi]
    nbytes = sum(u["reclaimed_bytes"] for u in us)
    return 1e3 * sum(u["wall_s"] for u in us) / (nbytes / GIB) \
        if nbytes else None


def read(run: dict, name: str):
    if name == "ttft_p95_ms":
        x = ttft_ms(run)
        return float(np.percentile(x, 95)) if x else None
    if name == "itl_p99_ms":
        x = itl_ms(run)
        return float(np.percentile(x, 99)) if x else None
    if name == "tokens_per_s":
        return tokens_in_window(run) / run["seconds"]
    if name == "setup_s":
        return run["setup_s"]
    raise KeyError(name)
