"""The one traffic generator: turns a mix file (``traffic/<mix>.json``) and
a seed into the invocations a run offers.

Open loop (``"loop": "open"``): a schedule of phases repeated every
``period_s``, each phase offering ``rate_share`` x the configuration's
capacity as a Poisson process (exponential gaps at the phase's rate, as
the port's ``serving/tracegen.py`` draws its bursty traces), each
invocation's function drawn by the Zipf shares; both from streams of the
mix's ``order_seed``.

Closed loop (``"loop": "closed"``): ``clients_per_profile`` clients per
function, each sending its next invocation when the last is done, the
first ones handed in in an order drawn from ``order_seed``.

The trace is the mix's, the same for every run: a run's ``--seed`` draws
the weights and the prompts (see ``harness``), so the work and its timing
repeat from run to run and only the numbers change.

Zipf popularity follows the Azure Functions trace's skew (Shahrad et al.,
ATC 2020), as the port's ``serving/tracegen.py`` does; per-stream seeds
are derived with ``zlib.crc32`` as there, so each replica's stream depends
on its own name only.
"""
from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    due_s: float          # seconds after the window opens
    replica: int          # index into the mix's ``replicas``
    profile: int          # index into the mix's ``profiles``


def stream_rng(seed: int, stream: str) -> np.random.Generator:
    """Independent generator for a named stream of one seed (copied from
    ``repro_torch.serving.tracegen.stream_seed``)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed), zlib.crc32(stream.encode())]))


def zipf_shares(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


def open_arrivals(mix: dict, capacity: float,
                  seconds: float) -> list[Arrival]:
    """Every invocation due in ``[0, seconds)``, sorted by due time."""
    sched = mix["schedule"]
    period = float(sched["period_s"])
    shares = zipf_shares(len(mix["profiles"]), mix["popularity"]["zipf_s"])
    out: list[Arrival] = []
    for ri, rep in enumerate(mix["replicas"]):
        times = stream_rng(mix["order_seed"], f"arrivals:{rep['id']}")
        picks = stream_rng(mix["order_seed"], f"profiles:{rep['id']}")
        offset = float(rep.get("phase_offset_s", 0.0))
        # phase starts, shifted by the replica's offset, from one period
        # before the window so an offset phase that straddles 0 is cut
        t = -period + offset % period
        while t < seconds:
            for ph in sched["phases"]:
                lo, hi = t, t + float(ph["seconds"])
                t = hi
                rate = ph["rate_share"] * capacity
                a, b = max(lo, 0.0), min(hi, seconds)
                if b <= a or rate <= 0:
                    continue
                # a Poisson process is memoryless: restart it at each
                # phase's start at that phase's rate
                due = a + float(times.exponential(1.0 / rate))
                while due < b:
                    fn = int(picks.choice(len(shares), p=shares))
                    out.append(Arrival(due, ri, fn))
                    due += float(times.exponential(1.0 / rate))
    out.sort(key=lambda x: (x.due_s, x.replica))
    return out


def closed_clients(mix: dict) -> list[tuple[int, int]]:
    """(replica, profile) of every client, in the order their first
    invocations are handed in."""
    per = int(mix["clients_per_profile"])
    clients = [(ri, pi) for ri in range(len(mix["replicas"]))
               for pi in range(len(mix["profiles"])) for _ in range(per)]
    order = stream_rng(mix["order_seed"], "clients").permutation(
        len(clients))
    return [clients[i] for i in order]


def check_mix(mix: dict) -> None:
    """Refuse a mix the generator cannot read, before any set-up."""
    for key in ("profiles", "popularity", "loop", "keep_alive_s",
                "replicas", "broker", "trace_window", "order_seed"):
        if key not in mix:
            raise ValueError(f"traffic mix lacks {key!r}")
    if mix["loop"] == "open":
        sched = mix["schedule"]
        total = sum(ph["seconds"] for ph in sched["phases"])
        if not math.isclose(total, sched["period_s"]):
            raise ValueError(f"phases last {total} s of a "
                             f"{sched['period_s']} s period")
    elif mix["loop"] != "closed":
        raise ValueError(f"unknown loop {mix['loop']!r}")
