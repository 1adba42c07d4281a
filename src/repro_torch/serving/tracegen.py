"""Bursty invocation traces (Azure Functions trace shape, synthesized).

The paper drives its evaluation with Azure traces [Shahrad et al. 2020]:
heavy initial bursts that spawn many instances, then an abrupt load drop
that triggers recycling and VM shrinking.  ``bursty_trace`` reproduces that
shape deterministically: Poisson base load overlaid with burst windows of
``burst_x`` higher rate, then a quiet tail.  ``diurnal_trace`` adds the
slow day/night modulation the multi-tenant scenario bank layers tenant
mixes on (one tenant peaking while another idles).

Per-stream seeding: a multi-tenant scenario draws one trace per tenant.
If every stream derived its rng from the same scalar seed, editing one
tenant's parameters would silently reshuffle every OTHER tenant's
arrivals (the draws are coupled through one generator sequence).
``stream_seed`` derives an independent, process-stable child seed from
``(seed, stream_name)`` — ``zlib.crc32``, NOT ``hash()``, which is
salted per process — so each tenant's interleaving is a function of its
own name and parameters only.  ``bursty_trace`` / ``diurnal_trace`` /
``assign_profiles`` take an optional ``stream=`` for exactly this; with
``stream=None`` they reproduce the legacy single-seed draws bit-for-bit.
"""
from __future__ import annotations

import zlib

import numpy as np


def stream_seed(seed: int, stream: str) -> np.random.SeedSequence:
    """Independent child seed for a named trace stream: stable across
    processes and unaffected by any other stream's parameters."""
    return np.random.SeedSequence([seed, zlib.crc32(stream.encode())])


def _stream_rng(seed: int, stream: str | None, legacy_offset: int = 0
                ) -> np.random.Generator:
    """Legacy path (``stream=None``): the original scalar-seed generator,
    bit-identical to the pre-stream behavior.  Named path: independent
    per-stream child."""
    if stream is None:
        return np.random.default_rng(seed + legacy_offset)
    return np.random.default_rng(stream_seed(seed, stream))


def bursty_trace(duration_s: float, base_rate: float, *, burst_x: float = 8.0,
                 burst_at: tuple[float, ...] = (0.0,), burst_len: float = 5.0,
                 quiet_after: float | None = None, seed: int = 0,
                 stream: str | None = None) -> list[float]:
    """Arrival times in [0, duration).  Rate = base_rate, x ``burst_x``
    inside burst windows, ~0 after ``quiet_after`` (the drop that triggers
    scale-down in the paper's Fig. 8)."""
    rng = _stream_rng(seed, stream)
    out: list[float] = []
    t = 0.0
    while t < duration_s:
        rate = base_rate
        for b in burst_at:
            if b <= t < b + burst_len:
                rate = base_rate * burst_x
        if quiet_after is not None and t >= quiet_after:
            rate = base_rate * 0.02
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        if t < duration_s:
            out.append(t)
    return out


def diurnal_trace(duration_s: float, base_rate: float, *,
                  period_s: float = 60.0, depth: float = 0.8,
                  phase: float = 0.0, seed: int = 0,
                  stream: str | None = None) -> list[float]:
    """Sinusoidally modulated Poisson arrivals: rate swings between
    ``base_rate * (1 - depth)`` and ``base_rate * (1 + depth)`` over
    ``period_s`` (the compressed day/night cycle).  Two tenants with
    opposite ``phase`` peak at opposite times — the diurnal-mix scenario's
    load shape, where one tenant's peak leans on the slack the other's
    trough frees up."""
    assert 0.0 <= depth <= 1.0, depth
    rng = _stream_rng(seed, stream)
    out: list[float] = []
    t = 0.0
    peak = base_rate * (1.0 + depth)
    while t < duration_s:
        # thinning: draw at the peak rate, keep with prob rate(t)/peak
        t += float(rng.exponential(1.0 / max(peak, 1e-9)))
        if t >= duration_s:
            break
        rate = base_rate * (1.0 + depth * np.sin(
            2.0 * np.pi * (t / period_s) + phase))
        if rng.uniform() * peak < rate:
            out.append(t)
    return out


def assign_profiles(arrivals: list[float], profiles: dict, seed: int = 0,
                    stream: str | None = None):
    """Randomly map arrivals to function profiles (weighted).  With a
    ``stream`` name the picks come from that stream's independent child
    rng (see module docstring); ``stream=None`` keeps the legacy
    ``seed + 1`` draws bit-identical."""
    rng = _stream_rng(seed, stream, legacy_offset=1)
    names = list(profiles)
    w = np.array([profiles[n].weight for n in names], float)
    w /= w.sum()
    picks = rng.choice(len(names), size=len(arrivals), p=w)
    return [(t, profiles[names[i]]) for t, i in zip(arrivals, picks)]
