"""``launch/serve_elastic.py``, the port's twin of the JAX package's
``examples/serve_elastic.py``: hotmem, vanilla and static on one bursty
trace of reduced qwen2-7b, against the JAX package's ``serve`` with the
example's arguments.

Both run under the fake clock of ``tests/test_torch_recurrent_serving.py``
patched into the engine, elastic, hotmem and vanilla modules of both
packages, so the schedules are deterministic: completed, killed, reclaimed
and migrated bytes and the p99 latency (virtual time) must be equal; the
reclaim walls are host time in either package and are compared for sign
only.  The clock advances ``CLOCK_STEP`` a read: at that file's 1e-4 s a
decode step is so short that the vanilla pool drains before it shrinks
and migrates nothing, in both packages; from 3e-4 s on, as on a real clock
(the JAX example's own run: 8.0 KiB), it migrates."""
import jax
import pytest
import torch

import repro.launch.serve as jax_serve
from repro_torch.launch import serve_elastic as se
from test_torch_recurrent_serving import (JAX_MODULES, TORCH_MODULES,
                                          _FakeClock)

torch.set_num_threads(1)
CLOCK_STEP = 1e-3
COUNTS = ("completed", "killed", "reclaimed_bytes", "migrated_bytes",
          "latency_p99")


def _faked(modules, fn):
    with pytest.MonkeyPatch.context() as mp:
        clock = _FakeClock(CLOCK_STEP)
        for mod in modules:
            mp.setattr(mod, "time", clock)
        return fn()


@pytest.fixture(scope="module")
def runs():
    """The example's three ``serve`` calls in the JAX package, and the
    port's launcher on the reduced config on the CPU with its printout;
    each package's three calls read one clock, as one process does."""
    want = _faked(JAX_MODULES, lambda: {mode: jax_serve.serve(
        "qwen2-7b", mode=mode, duration=16.0, rate=0.8, n_partitions=8,
        partition_tokens=128, keep_alive=3.0)[1] for mode in se.MODES})
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = _faked(TORCH_MODULES, lambda: se.serve_elastic(
            use_reduced=True, device="cpu"))
    jax.clear_caches()
    return want, got, buf.getvalue().splitlines()


@pytest.mark.parametrize("mode", se.MODES)
def test_counts_match_the_jax_example(mode, runs):
    want, got, _ = runs
    assert {k: got[mode][k] for k in COUNTS} == \
        {k: want[mode][k] for k in COUNTS}
    assert got[mode]["completed"] == got[mode]["submitted"]
    assert got[mode]["killed"] == 0


@pytest.mark.parametrize("mode", se.MODES)
def test_reclaim_walls_have_the_jax_sign(mode, runs):
    want, got, _ = runs
    assert (got[mode]["reclaim_wall_s"] > 0) == \
        (want[mode]["reclaim_wall_s"] > 0)
    assert got[mode]["reclaim_wall_s"] >= 0


def test_the_paper_contrast(runs):
    """hotmem reclaims with no migration; vanilla migrates to reclaim;
    static over-provisions and reclaims nothing."""
    _, got, _ = runs
    assert got["hotmem"]["reclaimed_bytes"] > 0
    assert got["hotmem"]["migrated_bytes"] == 0
    assert got["vanilla"]["migrated_bytes"] > 0
    assert got["static"]["reclaimed_bytes"] == 0


def test_prints_the_example_columns(runs):
    """The header and one row per mode in the example's six columns; the
    count columns as the JAX metrics format them."""
    want, got, lines = runs
    assert lines[0].split() == ["mode", "completed", "p99(s)",
                                "reclaimedKiB", "migratedKiB", "reclaim(s)"]
    for line, mode in zip(lines[1:4], se.MODES, strict=True):
        m = want[mode]
        cols = line.split()
        assert cols[:5] == [mode, str(m["completed"]),
                            f"{(m['latency_p99'] or 0):.2f}",
                            f"{m['reclaimed_bytes'] / 1024:.1f}",
                            f"{m['migrated_bytes'] / 1024:.1f}"]
        assert float(cols[5]) == pytest.approx(
            got[mode]["reclaim_wall_s"], abs=1e-4)
