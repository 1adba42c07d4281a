"""A top-k router judged on the CPU at a small size: ``reference/moe.py``
against the port, the causal rule that sets aside the slots computed from
a routing decision too close to call, and a small mixture-of-experts cell
(``small.py``'s model with 8 experts, top 2, capacity factor 4.0) driven
end to end, honest and with faults planted in the port; the experts' own
number, ``expert_kv_err``, and its limit in the configuration's file."""
import dataclasses
import json
import math
import time
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models import model as M
from repro_torch.models import moe as port_moe
from squeeze_bench import check, harness, weights
from squeeze_bench.reference import decoder, moe
from squeeze_bench.tests import small
from squeeze_bench.tests.test_sqb_pick import _run, _tree
from squeeze_bench.tests.test_sqb_reference import port_kv

torch.set_num_threads(1)

MOE = {"num_experts": 8, "num_experts_per_tok": 2,
       "moe_capacity_factor": 4.0, "sliding_window": 0, "qkv_bias": False,
       "rope_theta": 1e6, "norm_eps": 1e-5}
MIXTRAL = Path(__file__).resolve().parents[1] / "configs" \
    / "mixtral-8x7b-16l.json"

# expert_kv_err's limit on the small cell, from its sound readings on the
# CPU (seed 3, the prompts' hash seeds 1-28): 0.00147-0.00287; the
# expert-only fault of ``test_an_expert_only_fault_is_caught`` read
# 0.0085-0.0115 on the same 28
SMALL_LIMITS = {"expert_kv_err": 0.005}


def moe_config(**model) -> dict:
    """``small.py``'s cell on the port's Mixtral architecture: 8 experts,
    top 2, dropless (capacity factor 4.0 = 8 / 2), full attention, with
    its own limit of ``expert_kv_err``."""
    c = small.config()
    c["arch"] = "mixtral-8x7b"
    c["reference"] = "moe"
    c["model"].update(MOE, **model)
    c["limits"] = dict(SMALL_LIMITS)
    c["limits_set_from"] = "the small cell's sound runs on the CPU, " \
        "0.00147-0.00287 over 28 hash seeds of the prompts"
    return c


def execute(cfg, seed=3, tie=()):
    """One small saturated run and its collected rows.  ``tie``: router
    columns set equal to the first of them, before the window, in every
    layer but layer 0 (whose routes ``expert_kv_err``'s layer 1 is
    computed from)."""
    with pytest.MonkeyPatch.context() as mp:
        if tie:
            real = harness.Cell.warm_up

            def tied(cell):
                r = cell.params["decoder"]["groups"][0]["ffn"]["router"]
                for c in tie[1:]:
                    r[1:, :, c] = r[1:, :, tie[0]]
                real(cell)
            mp.setattr(harness.Cell, "warm_up", tied)
        run = harness.execute(cfg, small.mix("saturated"), seed=seed,
                              seconds=1.6, traced=False, device="cpu",
                              t_process=time.perf_counter())
    return run, check.collect(run)


def judge(cfg, run, items, kv_cache):
    """The verdict and numbers of rows collected once, as ``run.py``
    judges them, through ``kv_cache`` in the reference's place, held to
    the limits of ``cfg``."""
    numbers = check.bookkeeping(run)
    params, sizes = run["cell"].params, check.sizes(cfg)
    ref = check.reference(cfg)
    numbers.update(check.judge(run, items, lambda tok: kv_cache(
        sizes, params, tok, dtype=torch.bfloat16),
        at=check.layers(ref, sizes)))
    return check.verdict(numbers, check.limits(cfg, ref)), numbers


def run_cell(cfg, seed=3, reference=None):
    """One small saturated run judged as ``run.py`` judges it, through the
    configuration's reference or a stand-in for its ``kv_cache``."""
    kv_cache = reference or check.reference(cfg).kv_cache
    return judge(cfg, *execute(cfg, seed), kv_cache)


# -- the causal rule ------------------------------------------------------


def test_the_causal_rule_on_a_hand_made_mask():
    """Slot s at layer l is judged where every slot t <= s was settled at
    every layer below l: layer 0 always; a slot unsettled at layer l sets
    aside itself and every later slot at every layer above l."""
    settled = torch.ones(4, 6, dtype=torch.bool)
    settled[1, 2] = False           # slot 2's decision at layer 1
    settled[0, 4] = False           # slot 4's decision at layer 0
    settled[3, 0] = False           # the top layer's decisions judge nothing
    want = torch.tensor([
        [1, 1, 1, 1, 1, 1],
        [1, 1, 1, 1, 0, 0],
        [1, 1, 0, 0, 0, 0],
        [1, 1, 0, 0, 0, 0]], dtype=torch.bool)
    assert torch.equal(check.judged_slots(settled), want)
    assert check.judged_slots(torch.ones(3, 5, dtype=torch.bool)).all()
    none = check.judged_slots(torch.zeros(3, 5, dtype=torch.bool))
    assert none[0].all() and not none[1:].any()


# -- the reference against the port ----------------------------------------


def _small_moe():
    """The small cell's model as the port runs it, and its sizes."""
    cfg = harness.model_config(moe_config())
    return cfg, dataclasses.asdict(cfg)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 40 + 3])
def test_reference_matches_port_where_settled(seed):
    """Prefill of distinct tokens, then decode through the cache: the
    port's routes equal the reference's wherever the reference's are
    settled, and every K/V slot computed from routes that agree is within
    bf16 rounding of the port's."""
    cfg, sizes = _small_moe()
    params = weights.draw(M.param_specs(cfg), seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    prompt = torch.randint(1, cfg.vocab_size, (20,), generator=gen)
    seen = []
    real = port_moe.route

    def spy(c, p, xt):
        w, e = real(c, p, xt)
        seen.append(e.clone())
        return w, e
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_moe, "route", spy)
        k, v = port_kv(cfg, params, prompt, 8, rows=1, row=0)
    tokens = torch.cat([prompt, torch.zeros(8, dtype=torch.long)])
    rk, rv, experts, margins = moe.forward(sizes, params, tokens,
                                           dtype=torch.bfloat16)
    layers = cfg.num_layers
    port = torch.stack([torch.cat([seen[i]] + [seen[layers * (1 + j) + i]
                                               for j in range(8)])
                        for i in range(layers)])
    agree = (port.sort(-1).values == experts.sort(-1).values).all(-1)
    settled = margins > torch.tensor(
        [moe.tie_margin(i) for i in range(layers)])[:, None]
    assert agree[settled].all()
    same = check.judged_slots(agree)
    assert same[1:].any()
    keep = same[:, :, None, None]
    for prog, ref in ((k, rk), (v, rv)):
        assert check.slot_err(prog.float() * keep, ref * keep) < 0.03


def test_reference_sees_a_flipped_expert():
    """The same prefill with the port's routing taken to its second and
    third choices: the K/V of the layers above differ by far more than
    rounding."""
    cfg, sizes = _small_moe()
    params = weights.draw(M.param_specs(cfg), 4, "cpu")
    prompt = torch.randint(1, cfg.vocab_size, (20,),
                           generator=torch.Generator().manual_seed(4))

    def shifted(c, p, xt):
        probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
        w, e = probs.topk(3, dim=-1)
        w, e = w[:, 1:], e[:, 1:]
        return w / w.sum(-1, keepdim=True), e
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_moe, "route", shifted)
        k, _ = port_kv(cfg, params, prompt, 0, rows=1, row=0)
    rk, _, _ = moe.kv_cache(sizes, params, prompt, dtype=torch.bfloat16)
    assert check.slot_err(k[1:], rk[1:]) > 0.3


# -- what covers refuses ----------------------------------------------------


def _other(value):
    """A value of the field's type other than ``value``."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value + 3
    if isinstance(value, str):
        return value + "x"
    if isinstance(value, tuple):
        return () if value else ("attn", "local")
    raise TypeError(value)


@pytest.mark.parametrize("ref,arch,model", [
    (decoder, "qwen2-7b", {}),
    (moe, "mixtral-8x7b", MOE)])
def test_every_field_is_read_or_refused(ref, arch, model):
    """Every field of the port's ``ModelConfig`` is read by the reference,
    inert (a label, or what reaches no K/V slot), or held to one value
    (the port's default where it has one) and refused at any other; so a
    field added to the port later is refused until a reference judges
    it."""
    base = dataclasses.asdict(dataclasses.replace(get_config(arch), **model))
    ref.covers(base)
    fields = {f.name: f for f in dataclasses.fields(ModelConfig)}
    for name, f in fields.items():
        kinds = [name in ref.READS, name in ref.INERT, name in ref.FIXED]
        assert sum(kinds) == 1, (name, kinds)
        if name in ref.FIXED:
            if f.default is not dataclasses.MISSING:
                assert ref.FIXED[name] == f.default, name
            with pytest.raises(NotImplementedError):
                ref.covers(dict(base, **{name: _other(base[name])}))
        elif name in ref.INERT:
            ref.covers(dict(base, **{name: _other(base[name])}))
    assert set(ref.READS) | set(ref.INERT) | set(ref.FIXED) == set(fields)
    with pytest.raises(NotImplementedError, match="unknown"):
        ref.covers(dict(base, some_new_field=1))


@pytest.mark.parametrize("changes,reason", [
    ({"num_experts": 0, "num_experts_per_tok": 0}, "no experts"),
    ({"act": "gelu"}, "SiLU MLP"),
    ({"moe_capacity_factor": 1.25}, "drops tokens"),
    ({"moe_capacity_factor": 3.99}, "drops tokens"),
    ({"num_experts_per_tok": 8}, "top-8 routing over 8"),
    ({"sliding_window": 4096}, "sliding_window = 4096"),
    ({"attn_logit_softcap": 30.0}, "attn_logit_softcap"),
    ({"final_logit_softcap": 30.0}, "final_logit_softcap"),
    ({"query_scale": 0.1}, "query_scale"),
    ({"post_norms": True}, "post_norms"),
    ({"scale_embeddings": True}, "scale_embeddings"),
    ({"mrope_sections": (16, 24, 24)}, "mrope_sections"),
    ({"vision_stub_tokens": 4}, "vision_stub_tokens"),
    ({"local_window": 8}, "local_window"),
    ({"block_pattern": ("local", "attn")}, "block_pattern"),
    ({"tail_pattern": ("attn",)}, "tail_pattern"),
    ({"num_layers": 1}, "no layer's K/V were computed from an expert"),
])
def test_moe_covers_refuses_what_it_does_not_compute(changes, reason):
    _, sizes = _small_moe()
    moe.covers(sizes)
    with pytest.raises(NotImplementedError, match=reason):
        moe.covers(dict(sizes, **changes))


def test_sizes_are_what_the_program_runs():
    """``check.sizes`` lays the file's ``model`` over the registered
    architecture: a default the file leaves out is there (Mixtral's 1.25
    capacity factor, its 4,096-token window), and qwen2's sizes are the
    file's."""
    cfg = moe_config()
    assert check.sizes(cfg)["moe_capacity_factor"] == 4.0
    del cfg["model"]["moe_capacity_factor"], cfg["model"]["sliding_window"]
    sizes = check.sizes(cfg)
    assert sizes["moe_capacity_factor"] == 1.25
    assert sizes["sliding_window"] == 4096
    dense = small.config()
    assert {k: check.sizes(dense)[k] for k in dense["model"]} \
        == dense["model"]


@pytest.mark.parametrize("drop,reason", [
    ("moe_capacity_factor", "drops tokens over an expert's capacity"),
    ("sliding_window", "sliding_window = 4096"),
])
def test_run_refuses_what_the_merged_sizes_hold(tmp_path, drop, reason):
    """A configuration file that leaves out a size lets the registered
    default through to the program: ``run.py`` exits 2 before set-up where
    that default is one its reference refuses."""
    cfg = moe_config()
    del cfg["model"][drop]
    p = _run(_tree(tmp_path, cfg))
    assert p.returncode == 2, p.stderr[-2000:]
    assert p.stdout == ""
    assert reason in p.stderr


# -- a small MoE cell end to end ------------------------------------------


def test_honest_moe_cell_is_correct():
    (ok, shown), numbers = run_cell(moe_config())
    assert ok, shown
    assert numbers["rows_judged"] >= 1
    assert numbers["judged_share"] >= check.FLOORS["judged_share"]


def _capacity_125(cfg, n):
    c = int(n * cfg.num_experts_per_tok * 1.25 / cfg.num_experts)
    return max(((c + 7) // 8) * 8, 8)


def _top1(cfg, p, xt):
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    w, e = probs.topk(cfg.num_experts_per_tok, dim=-1)
    return torch.cat([torch.ones_like(w[:, :1]),
                      torch.zeros_like(w[:, 1:])], -1), e


def _unnormalised(cfg, p, xt):
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    return probs.topk(cfg.num_experts_per_tok, dim=-1)


@pytest.mark.parametrize("name,fault", [
    ("capacity", _capacity_125), ("route", _top1),
    ("route", _unnormalised)])
def test_planted_routing_fault_is_caught(monkeypatch, name, fault):
    """Capacity at the registered 1.25 (a repeated-token prompt sends all
    of its tokens to the same two experts, which keep 5 in 16), top-1
    routing, and weights left un-renormalised: each reads not correct."""
    monkeypatch.setattr(port_moe, name, fault)
    (ok, shown), numbers = run_cell(moe_config())
    assert not ok, shown
    assert numbers["kv_head_err"] > check.LIMITS["kv_head_err"]


def _reversed_ties(cfg, p, xt):
    """The port's routing with exact ties broken toward the higher
    expert index (``topk`` breaks them toward the lower)."""
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    w, e = probs.flip(-1).topk(cfg.num_experts_per_tok, dim=-1)
    return w / w.sum(-1, keepdim=True), cfg.num_experts - 1 - e


def test_tied_router_columns_are_set_aside(monkeypatch):
    """All eight router columns equal in layers 1 and 2 of three, and the
    port breaking ties the other way: every decision there has margin 0
    and the two sides pick different experts.  On the same rows, the
    slots computed from such a choice (layer 2's) are set aside and the
    run is correct; judged whole, it is not.  Layer 0 keeps its router:
    ties there set all of layer 1 aside on some prompts, and then
    ``expert_kv_err`` has nothing to read, which fails."""
    monkeypatch.setattr(port_moe, "route", _reversed_ties)
    cfg = moe_config(num_layers=3)
    run, items = execute(cfg, tie=tuple(range(8)))
    (ok, shown), numbers = judge(cfg, run, items, moe.kv_cache)
    assert ok, shown
    assert numbers["judged_share"] < 1.0

    def every_slot(model, params, tokens, dtype):
        k, v, settled = moe.kv_cache(model, params, tokens, dtype=dtype)
        return k, v, torch.ones_like(settled)
    (ok, shown), numbers = judge(cfg, run, items, every_slot)
    assert not ok and numbers["kv_head_err"] > check.LIMITS["kv_head_err"]


def test_a_reference_that_sets_everything_aside_fails_on_the_floor():
    """Only layer 0 is judged, on a model deep enough that one layer in
    its depth is under the floor."""
    layers = 1 + int(1 / check.FLOORS["judged_share"])

    def nothing_settled(model, params, tokens, dtype):
        k, v, settled = moe.kv_cache(model, params, tokens, dtype=dtype)
        return k, v, torch.zeros_like(settled)
    (ok, shown), numbers = run_cell(moe_config(num_layers=layers),
                                    reference=nothing_settled)
    assert numbers["judged_share"] == pytest.approx(1 / layers)
    assert not ok
    assert shown["judged_share"][0] < shown["judged_share"][1]
    assert all(v <= lim for k, (v, lim) in shown.items()
               if k in check.LIMITS)


def test_dense_numbers_are_the_same_with_an_all_settled_mask():
    """The dense reference's two tensors and the same with every slot
    settled judge the same rows to the same numbers, bit for bit."""
    cfg = small.config()
    run = harness.execute(cfg, small.mix("saturated"), seed=5, seconds=1.6,
                          traced=False, device="cpu",
                          t_process=time.perf_counter())
    items = check.collect(run)
    params = run["cell"].params
    sizes = check.sizes(cfg)

    def two(tok):
        return decoder.kv_cache(sizes, params, tok, dtype=torch.bfloat16)

    def three(tok):
        k, v = two(tok)
        return k, v, torch.ones(k.shape[:2], dtype=torch.bool)
    a, b = check.judge(run, items, two), check.judge(run, items, three)
    assert a["rows_judged"] >= 1 and a["judged_share"] == 1.0
    assert a == b


# -- the experts' own number: expert_kv_err ------------------------------


def test_the_mixtral_file_passes_the_reference_check():
    """The committed configuration is judged by ``moe`` on the sizes the
    program runs (``check.sizes``; no weights drawn), which are the file's,
    and states ``expert_kv_err``'s limit, read at layer 1."""
    cfg = json.loads(MIXTRAL.read_text())
    ref = check.reference(cfg)
    assert ref is moe
    sizes = check.sizes(cfg)
    assert {k: sizes[k] for k in cfg["model"]} == cfg["model"]
    assert check.layers(ref, sizes) == {"expert_kv_err": 1}
    assert check.limits(cfg, ref) == {
        **check.LIMITS, "expert_kv_err": cfg["limits"]["expert_kv_err"]}


@pytest.mark.parametrize("reading", ["at", "above", "unread"])
def test_verdict_holds_expert_kv_err_to_the_files_limit(reading):
    """At the file's limit the number passes; the next float above it, or
    no reading (nothing judged at its layer), fails.  It is shown after
    the shared limits, beside the file's limit."""
    cfg = json.loads(MIXTRAL.read_text())
    lim = cfg["limits"]["expert_kv_err"]
    numbers = dict.fromkeys(check.LIMITS, 0)
    numbers.update(rows_judged=5, judged_share=0.5, expert_kv_err={
        "at": lim, "above": math.nextafter(lim, 1.0), "unread": None}[
            reading])
    ok, shown = check.verdict(numbers, check.limits(cfg, moe))
    assert ok is (reading == "at")
    assert shown["expert_kv_err"] == [numbers["expert_kv_err"], lim]
    assert list(shown) == [*check.LIMITS, "expert_kv_err", *check.FLOORS]


def test_an_expert_only_fault_is_caught(monkeypatch):
    """Each expert block's output scaled by 1.03 as the port computes it,
    attention untouched: lower precision in the experts, in small.  Over
    the prompts' hash seeds 1-28 it read ``expert_kv_err`` 0.0085-0.0115,
    against the sound 0.0015-0.0029 and the small cell's limit 0.005,
    while ``kv_head_err`` read 0.0095-0.0121 and ``kv_err`` 0.0050-0.0065,
    under the shared 0.016 and 0.020: only ``expert_kv_err`` fails."""
    real = port_moe.moe_block
    monkeypatch.setattr(port_moe, "moe_block",
                        lambda cfg, p, x: real(cfg, p, x) * 1.03)
    (ok, shown), numbers = run_cell(moe_config())
    assert not ok
    failed = [k for k, (v, lim) in shown.items()
              if (v < lim if k in check.FLOORS else v > lim)]
    assert failed == ["expert_kv_err"], shown
    assert numbers["kv_head_err"] <= check.LIMITS["kv_head_err"]
    assert numbers["kv_err"] <= check.LIMITS["kv_err"]


def test_honest_moe_cell_reads_expert_kv_err_at_layer_1():
    (ok, shown), numbers = run_cell(moe_config(), seed=7)
    assert ok, shown
    assert numbers["expert_kv_err"] <= SMALL_LIMITS["expert_kv_err"]
    assert numbers["kv_layers"][1] == round(numbers["expert_kv_err"], 5)


def test_a_dense_runs_checks_are_the_shared_ones():
    """A dense configuration states no limit and its reference asks for no
    number: its limits are ``LIMITS``; judged with its reference's layers
    the numbers are those judged without, bit for bit; and the checks
    shown are those of the shared limits, keys and order kept."""
    cfg = small.config()
    run = harness.execute(cfg, small.mix("saturated"), seed=5, seconds=1.6,
                          traced=False, device="cpu",
                          t_process=time.perf_counter())
    items = check.collect(run)
    params, sizes = run["cell"].params, check.sizes(cfg)
    ref = check.reference(cfg)
    assert check.limits(cfg, ref) == check.LIMITS
    assert check.layers(ref, sizes) == {}

    def kv(tok):
        return ref.kv_cache(sizes, params, tok, dtype=torch.bfloat16)
    plain = check.judge(run, items, kv)
    assert check.judge(run, items, kv, at=check.layers(ref, sizes)) == plain
    numbers = {**check.bookkeeping(run), **plain}
    got = check.verdict(numbers, check.limits(cfg, ref))
    assert got == check.verdict(numbers)
    assert got[0] and list(got[1]) == [*check.LIMITS, *check.FLOORS]
