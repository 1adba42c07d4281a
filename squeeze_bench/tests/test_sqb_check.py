"""What decides ``correct``, driven end to end on the CPU at a small size
(``small.py``): the harness's look for a card is skipped, the rest of a run
is driven, and a sound run comes out correct while each planted fault,
the control, and the program's own warm-row fault come out not correct."""
import time

import pytest
import torch

from repro_torch.models import model as M
from squeeze_bench import check, harness, weights
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


# -- the int8x control: the int8 control with the experts on int8's grid --


def _served(cfg, control):
    """The weights a cell of ``cfg`` serves under ``control``, and the
    cell."""
    cell = harness.Cell(cfg, small.mix("saturated"), 3, "cpu",
                        control=control)
    return dict(weights._walk(cell.reps[0].engine.params)), cell


def _moe():
    from squeeze_bench.tests.test_sqb_moe import moe_config
    return moe_config()


def test_int8x_puts_every_expert_matrix_on_its_int8_grid():
    """Each expert matrix served is what rounding the drawn one to int8's
    per-output-channel grid (symmetric, absmax / 127) gives, kept in bf16,
    worked out here over the whole stack at once: at most 255 levels in
    each output channel.  Once the program's state is freed, the weights
    the reference reads are those drawn from the seed again, bit for
    bit."""
    served, cell = _served(_moe(), "int8x")
    drawn = dict(weights._walk(weights.draw(M.param_specs(cell.cfg), 3,
                                            "cpu")))
    ffn = ("decoder", "groups", 0, "ffn")
    for name in ("gate", "up", "down"):
        w0 = drawn[ffn + (name,)].float()
        scale = w0.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12) / 127
        q = torch.round(w0 / scale).clamp(-127, 127)
        got = served[ffn + (name,)]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, (q * scale).to(torch.bfloat16))
        assert not torch.equal(got, drawn[ffn + (name,)])
        levels = q.transpose(-1, -2).flatten(0, -2)
        assert max(len(torch.unique(c)) for c in levels) <= 255
    assert torch.equal(served[ffn + ("router",)], drawn[ffn + ("router",)])
    cell.reps[0].engine = None
    ref = dict(weights._walk(cell.reference_params()))
    assert ref.keys() == drawn.keys()
    assert all(torch.equal(ref[k], drawn[k]) for k in drawn)


def test_int8x_quantises_the_projections_as_int8_does():
    """Every leaf but the experts is served as ``--control int8`` serves
    it: the attention projections and the output head as int8 with their
    per-channel scales, the router and the norms as drawn."""
    a, _ = _served(_moe(), "int8")
    b, _ = _served(_moe(), "int8x")
    assert a.keys() == b.keys()
    experts = {("decoder", "groups", 0, "ffn", n) for n in ("gate", "up",
                                                            "down")}
    rest = a.keys() - experts
    assert any(a[k].dtype == torch.int8 for k in rest)
    assert ("decoder", "groups", 0, "attn", "q", "qscale") in rest
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
               for k in rest)


def test_int8e_rounds_the_experts_alone():
    """``int8e`` serves the experts as ``int8x`` does and every other leaf
    as drawn: lower precision in the experts alone."""
    served, cell = _served(_moe(), "int8e")
    x, _ = _served(_moe(), "int8x")
    drawn = dict(weights._walk(weights.draw(M.param_specs(cell.cfg), 3,
                                            "cpu")))
    assert served.keys() == drawn.keys()
    for k, v in served.items():
        want = x[k] if k[-2:-1] == ("ffn",) and k[-1] != "router" \
            else drawn[k]
        assert v.dtype == want.dtype and torch.equal(v, want), k


def test_int8x_on_a_dense_tree_is_int8():
    a, _ = _served(small.config(), "int8")
    b, _ = _served(small.config(), "int8x")
    assert a.keys() == b.keys()
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
               for k in a)


@pytest.mark.parametrize("control", sorted(weights.CONTROLS))
def test_every_control_is_a_choice_of_run(control):
    from squeeze_bench import run
    args = run.parse(["--workload", "w", "--seed", "1", "--seconds", "1",
                      "--control", control])
    assert args.control == control
