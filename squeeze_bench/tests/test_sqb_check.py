"""What decides ``correct``, driven end to end on the CPU at a small size
(``small.py``): the harness's look for a card is skipped, the rest of a run
is driven, and a sound run comes out correct while each planted fault,
the control, and the program's own warm-row fault come out not correct."""
import time

import pytest
import torch

from repro_torch.models import model as M
from squeeze_bench import check, harness
from squeeze_bench.check import LIMITS
from squeeze_bench.reference import decoder
from squeeze_bench.tests import small

torch.set_num_threads(1)


def run_cell(mix_name, seed=3, control=None, seconds=1.6):
    """One small run judged as ``run.py`` judges it: through the
    configuration's own reference."""
    cfg, mix = small.config(), small.mix(mix_name)
    reference = check.reference(cfg)
    run = harness.execute(cfg, mix, seed=seed, seconds=seconds,
                          traced=False, device="cpu",
                          t_process=time.perf_counter(), control=control)
    numbers = check.bookkeeping(run)
    items = check.collect(run)
    params = run["cell"].params
    model = check.sizes(cfg)
    numbers.update(check.judge(run, items, lambda tok: reference.kv_cache(
        model, params, tok, dtype=torch.bfloat16)))
    return check.verdict(numbers), numbers, run


def test_the_picked_reference_judges_bit_equal_to_the_dense_one():
    """With no ``reference`` key the picker gives ``decoder``, and a small
    cell judged through it reads the same numbers, bit for bit, as one
    judged through ``decoder.kv_cache`` directly."""
    cfg = small.config()
    assert "reference" not in cfg
    run = harness.execute(cfg, small.mix("saturated"), seed=5, seconds=1.6,
                          traced=False, device="cpu",
                          t_process=time.perf_counter())
    items = check.collect(run)
    params = run["cell"].params
    picked = check.reference(cfg)
    model = check.sizes(cfg)
    via_pick = check.judge(run, items, lambda tok: picked.kv_cache(
        model, params, tok, dtype=torch.bfloat16))
    direct = check.judge(run, items, lambda tok: decoder.kv_cache(
        model, params, tok, dtype=torch.bfloat16))
    assert picked is decoder
    assert via_pick["rows_judged"] >= 1
    assert via_pick == direct


@pytest.mark.parametrize("mix", ["burst_snapshot", "saturated"])
def test_sound_run_is_correct(mix):
    (ok, shown), numbers, run = run_cell(mix)
    assert ok, shown
    assert numbers["rows_judged"] >= 1
    assert numbers["kv_err"] < LIMITS["kv_err"]


def test_state_left_unchanged_is_caught(monkeypatch):
    real = M.decode_step

    def stale(cfg, params, tokens, positions, caches):
        scratch = M.cache_axis_map(caches, lambda x, ax: x.clone())
        logits, _ = real(cfg, params, tokens, positions, scratch)
        return logits, caches
    monkeypatch.setattr(M, "decode_step", stale)
    (ok, shown), numbers, _ = run_cell("saturated")
    assert not ok and numbers["kv_head_err"] > LIMITS["kv_head_err"]


class LeftOut:
    """A decode step that leaves out one half of the rows, with the mean of
    the other half's logits in their place.  It records the (row, function,
    position) slots that the step did write, and holds the window open
    until a row bound to an invocation has a decode slot that no step
    wrote: only rows bound at the close are judged, and at some closes of
    the small window none of them lies in the half left out."""

    def __init__(self, monkeypatch, upper: bool):
        from repro_torch.serving.engine import ServeEngine
        real_step, real_decode = M.decode_step, ServeEngine._decode
        real_run = harness.Runner.run
        self.written: set = set()
        self.engine = None
        self.bound = False

        def decode(eng):
            self.engine = eng
            real_decode(eng)

        def step(cfg, params, tokens, positions, caches):
            b = tokens.shape[0]
            if upper:
                lo, h = 0, max(1, b // 2)
            else:
                lo, h = b // 2, b - b // 2
            part = M.cache_axis_map(caches, lambda x, ax: x.narrow(ax, lo, h))
            logits, _ = real_step(cfg, params, tokens[lo:lo + h],
                                  positions[lo:lo + h], part)
            rest = logits.mean(0, keepdim=True).expand(b - h, -1)
            self._wrote(range(lo, lo + h), positions)
            return torch.cat([logits, rest] if upper else [rest, logits]), \
                caches

        def run(runner, until, arrivals=None, stop=None, trace_at=None):
            real_run(runner, until, arrivals, stop, trace_at)
            if stop is None:            # the window, not the first starts
                cap = runner.cell.clock() + 30.0
                real_run(runner, float("inf"), arrivals, stop=lambda: (
                    self.unwritten() or runner.cell.clock() > cap))
                self.bound = self.unwritten()

        monkeypatch.setattr(ServeEngine, "_decode", decode)
        monkeypatch.setattr(M, "decode_step", step)
        monkeypatch.setattr(harness.Runner, "run", run)

    def _wrote(self, rows, positions) -> None:
        bound = self.engine._row_req if self.engine is not None else {}
        for row in rows:
            if row in bound:
                self.written.add((row, bound[row].profile.name,
                                  int(positions[row])))

    def unwritten(self) -> bool:
        """A row bound now holds a decode slot that no step wrote."""
        return any((row, req.profile.name, pos) not in self.written
                   for row, req in self.engine._row_req.items()
                   for pos in range(req.profile.prompt_tokens, req.position))


def test_half_the_batch_left_out_is_caught(monkeypatch):
    fault = LeftOut(monkeypatch, upper=True)
    (ok, shown), _, _ = run_cell("saturated")
    assert fault.bound and not ok


def test_lower_half_of_the_batch_left_out_is_caught(monkeypatch):
    fault = LeftOut(monkeypatch, upper=False)
    (ok, shown), _, _ = run_cell("saturated")
    assert fault.bound and not ok


@pytest.mark.parametrize("mix", ["burst_snapshot", "saturated"])
def test_altered_token_is_caught(monkeypatch, mix):
    real = M.prefill

    def altered(cfg, params, batch, caches):
        tok = batch["tokens"].clone()
        tok[:, -1] += 1
        return real(cfg, params, {**batch, "tokens": tok}, caches)
    monkeypatch.setattr(M, "prefill", altered)
    (ok, shown), _, _ = run_cell(mix)
    assert not ok


def test_clock_run_ahead_is_caught(monkeypatch):
    from repro_torch.serving.engine import ServeEngine
    real = ServeEngine._decode

    def jump(self):
        real(self)
        self.now += 1.0                    # a clock jump past the wall
    monkeypatch.setattr(ServeEngine, "_decode", jump)
    (ok, shown), _, _ = run_cell("saturated")
    assert not ok and shown["clock_ahead"][0] > 0


def test_control_reads_above_the_sound_run():
    """The port's int8 weight path in place of bf16: at this size its
    error is about twice the sound run's (at the cell's size the limit
    sits between the two; see PERF.md)."""
    _, sound, _ = run_cell("saturated")
    _, ctrl, _ = run_cell("saturated", control="int8")
    assert ctrl["kv_err"] > 2 * sound["kv_err"]


def test_warm_rows_decoded_while_idle_are_caught():
    """The program's fault that keeps the keep-alive mix out of the
    benchmark: every decode step writes K/V slot 0 of each row bound to no
    invocation, warm containers' rows included, so a warm re-bind, or a
    capture of a warm row, serves a prompt whose first slot was
    overwritten."""
    (ok, shown), numbers, run = run_cell("burst", seconds=3.0)
    assert run["counters"][0]["warm"] + run["counters"][0]["restore"] > 0
    assert not ok and numbers["kv_head_err"] > 0.3


def test_idle_clock_jump_is_caught():
    """Every iteration is the engine's own ``_tick``: with warm containers
    draining and nothing running, it moves the engine's clock on by
    ``keep_alive / 8``, past the wall clock, and the run counts it."""
    (ok, shown), numbers, run = run_cell("burst", seconds=3.0)
    assert not ok and numbers["clock_ahead"] > 0
