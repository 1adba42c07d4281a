"""The traffic generator: the same seed gives the same invocations, drawn
as a Poisson process at each phase's rate with Zipf-distributed
functions."""
from collections import Counter

import numpy as np
import pytest

from squeeze_bench import traffic as T
from squeeze_bench.harness import ROOT, load_json

MIXES = ["burst", "burst_snapshot", "saturated"]


@pytest.mark.parametrize("name", MIXES)
def test_mix_files_are_readable(name):
    mix = load_json(ROOT / "traffic" / f"{name}.json")
    T.check_mix(mix)
    assert len(mix["profiles"]) == 8


@pytest.mark.parametrize("order_seed", [0, 7, 2 ** 31 + 11, 3 * 2 ** 33])
def test_open_arrivals_repeat(order_seed):
    mix = load_json(ROOT / "traffic" / "burst_snapshot.json")
    mix["order_seed"] = order_seed
    a = T.open_arrivals(mix, 13.0, 51.0)
    assert a == T.open_arrivals(mix, 13.0, 51.0)
    assert all(0.0 <= x.due_s < 51.0 for x in a)
    assert [x.due_s for x in a] == sorted(x.due_s for x in a)


def test_order_seed_changes_the_trace():
    mix = load_json(ROOT / "traffic" / "burst_snapshot.json")
    runs = []
    for s in (1, 2):
        mix["order_seed"] = s
        runs.append(T.open_arrivals(mix, 13.0, 51.0))
    assert [x.due_s for x in runs[0]] != [x.due_s for x in runs[1]]


def _phase_counts(mix, capacity, periods):
    sched = mix["schedule"]
    period = sched["period_s"]
    burst = sched["phases"][0]["seconds"]
    a = T.open_arrivals(mix, capacity, periods * period)
    n_burst = sum(1 for x in a if x.due_s % period < burst)
    return a, n_burst, len(a) - n_burst


def test_burst_counts_follow_the_schedule():
    mix = load_json(ROOT / "traffic" / "burst_snapshot.json")
    (b, q) = mix["schedule"]["phases"]
    a, n_burst, n_quiet = _phase_counts(mix, 10.0, 400)
    want_b = 400 * 10.0 * b["rate_share"] * b["seconds"]
    want_q = 400 * 10.0 * q["rate_share"] * q["seconds"]
    # Poisson counts: within five standard deviations
    assert abs(n_burst - want_b) < 5 * want_b ** 0.5
    assert abs(n_quiet - want_q) < 5 * want_q ** 0.5


def test_gaps_are_exponential():
    """Inside a burst the gaps have the exponential's mean and a
    coefficient of variation near 1 (evenly spaced arrivals have 0)."""
    mix = load_json(ROOT / "traffic" / "burst_snapshot.json")
    sched = mix["schedule"]
    period, burst = sched["period_s"], sched["phases"][0]["seconds"]
    rate = 10.0 * sched["phases"][0]["rate_share"]
    a = T.open_arrivals(mix, 10.0, 400 * period)
    gaps = [y.due_s - x.due_s for x, y in zip(a, a[1:])
            if y.due_s % period < burst and x.due_s % period < burst
            and int(x.due_s // period) == int(y.due_s // period)]
    g = np.array(gaps)
    assert abs(g.mean() * rate - 1.0) < 0.05
    assert abs(g.std() / g.mean() - 1.0) < 0.05


def test_capacity_follows_the_mix():
    from squeeze_bench.harness import capacity
    cfg = load_json(ROOT / "configs" / "qwen2-7b.json")
    mix = load_json(ROOT / "traffic" / "burst_snapshot.json")
    shares = T.zipf_shares(8, 1.1)
    mean = sum(s * p["decode_tokens"] for s, p in zip(shares,
                                                      mix["profiles"]))
    assert np.isclose(capacity(cfg, mix),
                      cfg["capacity_tokens_per_s"] / mean)
    assert 150 < mean < 200


def test_zipf_picks():
    shares = T.zipf_shares(8, 1.1)
    assert np.isclose(shares.sum(), 1.0)
    assert all(shares[i] > shares[i + 1] for i in range(7))
    mix = load_json(ROOT / "traffic" / "burst_snapshot.json")
    a = T.open_arrivals(mix, 10.0, 200 * mix["schedule"]["period_s"])
    got = np.bincount([x.profile for x in a], minlength=8) / len(a)
    assert np.allclose(got, shares, atol=0.02)


def test_closed_clients_repeat():
    mix = load_json(ROOT / "traffic" / "saturated.json")
    a, b = T.closed_clients(mix), T.closed_clients(mix)
    assert a == b and len(a) == 64
    assert Counter(p for _, p in a) == Counter({i: 8 for i in range(8)})
    mix["order_seed"] += 1
    assert a != T.closed_clients(mix)


@pytest.mark.parametrize("bad", [{"loop": "open"}, {"loop": "sideways"}])
def test_check_mix_refuses(bad):
    mix = load_json(ROOT / "traffic" / "burst_snapshot.json")
    mix.update(bad)
    if bad["loop"] == "open":
        mix["schedule"]["period_s"] = 99.0
    with pytest.raises(ValueError):
        T.check_mix(mix)
