"""What decides ``correct``: the K/V rows the window produced, against the
plain reference, and the bookkeeping of the window.

The engine serves no token it computed (every decode step feeds token 0
and its logits are dropped), so what the timed path makes for each
invocation is its cache row: the prompt's K/V, written by a cold-start
prefill or copied back from the host snapshot pool, then one K/V slot per
decode step, through ``partition_attention`` in every layer before.  Once
the window has closed and the peak memory is read, the harness copies out
every row bound to an invocation and every staged row in the host pool,
frees the program's state, and runs the reference once per function over
the ids this process's engine used (its prompt token, ``hash(name) % 97 +
1``, ``prompt_tokens`` times, then token 0 at every decode position).

The reference is the configuration's (``reference``): a module under
``reference/`` named in its file, ``decoder`` where the file names none,
run in the configuration's type on the sizes the program runs
(``sizes``).  ``decoder`` is the plain published dense block in bf16,
with the norms, RoPE angles and softmax in f32 and the matmuls
accumulating in f32.

A reference may also say which of its routing decisions were settled (a
third tensor, (layers, S) bool: ``reference/moe.py``'s top-k router, whose
near-ties the program may break the other way).  Slot s of a sequence is
judged at layer l only where every slot t <= s was settled at every layer
below l, since its K/V were computed from those alone (``judged_slots``);
a reference that returns two tensors has every written slot judged.
Numbers compared, each with its limit (``LIMITS``) or floor
(``FLOORS``):
  kv_head_err   worst over the judged rows of |program - reference| /
                |reference| over the row's judged slots, K and V, in
                each of the first ``HEAD_LAYERS`` layers (a slot written
                wrong anywhere in a row shows here);
  kv_err        the same over all judged rows and slots pooled, layer by
                layer, averaged over the layers that have a judged slot;
  clock_ahead   iterations after which an engine's clock read past the
                wall clock;
  prefix_diff   rows whose prompt slots differ by a bit from the host
                pool's staged row of the same function (a restore copies
                those bytes; a cold prefill of the same prompt computes
                them);
  migrated      bytes an unplug migrated, and kv_compact launches;
  freed_diff    per unplug, |device memory freed - bytes reclaimed| plus
                |bytes reclaimed - rows dropped x row bytes|;
  killed        invocations killed for overrunning their partition;
  rows_judged   rows with a judged slot (at least one);
  judged_share  judged (layer, slot) pairs over written ones (at least
                ``FLOORS["judged_share"]``).

A reference may ask for numbers of its own (``NUMBERS``: each name with a
function of the sizes that gives a layer), each the pooled K/V error of
that layer over its judged slots, K and V together (``None`` where no slot
of it was judged, which fails).  Their limits are the configuration's:
its file states each under ``"limits"``, beside ``"limits_set_from"``,
the readings it was set from (``limits``); ``reference/moe.py`` asks for
``expert_kv_err``.  A dense configuration states none and is held to the
shared limits alone.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import re

import torch

# limits: see PERF.md for the readings each was set from
LIMITS = {
    "kv_head_err": 0.016,
    "kv_err": 0.020,
    "clock_ahead": 0,
    "prefix_diff": 0,
    "migrated": 0,
    "freed_diff": 0,
    "killed": 0,
}
# floors: each number at least this (see PERF.md for the readings).
# judged_share: a dense reference judges every slot (1.0); the trial
# Mixtral-8x7B cell on 16 layers read 0.156-0.424 over 8 seeds on an H100,
# and the floor is under half the lowest, above the 1/16 that a reference
# setting every routing decision aside would read there (layer 0 only)
FLOORS = {
    "rows_judged": 1,
    "judged_share": 0.075,
}


HEAD_LAYERS = 4         # the layers ``kv_head_err`` covers


def sizes(config: dict) -> dict:
    """Every field of the ``ModelConfig`` the program runs for ``config``
    (the registered architecture with the file's ``model`` laid over it),
    as a plain dict: what a reference's ``covers`` and ``kv_cache`` read,
    so that a default the file leaves out cannot slip past ``covers``."""
    from squeeze_bench import harness
    return dataclasses.asdict(harness.model_config(config))


def reference(config: dict):
    """The plain reference module that judges ``config``: the bare name in
    its ``"reference"`` key (``decoder`` where it has none) of a module
    under ``reference/``, holding ``covers(model)`` and ``kv_cache(model,
    params, tokens, dtype=...)``, whose ``covers`` accepted ``sizes
    (config)``.  Raises ``ValueError`` with a one-line reason otherwise."""
    name = config.get("reference", "decoder")
    if not isinstance(name, str) \
            or not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"reference {name!r} is not the bare name of a "
                         "module under squeeze_bench/reference/")
    full = f"squeeze_bench.reference.{name}"
    try:
        mod = importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise ValueError(f"no reference module {name!r} under "
                         "squeeze_bench/reference/") from None
    missing = [f for f in ("covers", "kv_cache")
               if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"reference {name!r} lacks {', '.join(missing)}")
    try:
        mod.covers(sizes(config))
    except NotImplementedError as e:
        raise ValueError(f"reference {name!r} does not cover this "
                         f"configuration's model: {e}") from None
    limits(config, mod)
    return mod


def limits(config: dict, ref) -> dict:
    """``LIMITS``, and for each number that ``ref`` asks for (``NUMBERS``)
    the limit that the configuration's file states under ``"limits"``.
    Raises ``ValueError`` with a one-line reason where the file leaves
    one out, states one that is not a positive number or that its
    reference asks for no number of (a shared limit too), or says under
    ``"limits_set_from"`` nothing of the readings it set them from."""
    name = config.get("reference", "decoder")
    asked = getattr(ref, "NUMBERS", {})
    stated = config.get("limits", {})
    if not isinstance(stated, dict):
        raise ValueError("limits is not an object of limits by number")
    extra = sorted(set(stated) - set(asked))
    if extra:
        raise ValueError(f"limits states {', '.join(extra)}, which "
                         f"reference {name!r} asks for no number of")
    missing = [n for n in asked if n not in stated]
    if missing:
        raise ValueError(f"reference {name!r} asks for "
                         f"{', '.join(missing)}, whose limit the "
                         "configuration does not state under limits")
    for n, v in stated.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)) \
                or not 0 < v < math.inf:
            raise ValueError(f"limit {n} = {v!r} is not a positive number")
    said = config.get("limits_set_from")
    if stated and not (isinstance(said, str) and said.strip()):
        raise ValueError("limits_set_from does not say which readings the "
                         "limits were set from")
    return {**LIMITS, **stated}


def layers(ref, model: dict) -> dict:
    """{number: layer} of each number that ``ref`` asks for, on the sizes
    ``model``."""
    return {n: f(model) for n, f in getattr(ref, "NUMBERS", {}).items()}


def prompt_token(name: str) -> int:
    """The token a cold start repeats, as the engine computes it in this
    process (``str`` hashes are salted per process)."""
    return hash(name) % 97 + 1


def _row_kv(caches, row: int, length: int):
    g = caches["groups"][0]
    return (g["k"][:, row, :length].clone(), g["v"][:, row, :length].clone())


def collect(run: dict) -> list[dict]:
    """Copies of every judged row: rows bound to an invocation at the close
    (``length`` = the slots written) and the host pool's staged rows
    (prompt + decode slots of the invocation they were captured from)."""
    cell = run["cell"]
    items = []
    for rep in cell.reps:
        eng = rep.engine
        for row, req in eng._row_req.items():
            k, v = _row_kv(eng.caches, row, req.position)
            items.append({"name": req.profile.name, "src": "row",
                          "prompt": req.profile.prompt_tokens,
                          "length": req.position, "k": k, "v": v})
    pool = cell.broker.snapshots
    profs = {p.name: p for rep in cell.reps for p in rep.profiles}
    for key in (pool.keys() if pool is not None else []):
        snap = pool.peek(key)
        tree = snap.payload.tree()
        p = profs[key]
        n = p.prompt_tokens + p.decode_tokens
        g = tree["groups"][0]
        items.append({"name": key, "src": "pool", "prompt": p.prompt_tokens,
                      "length": n,
                      "k": g["k"][:, 0, :n].to(cell.device),
                      "v": g["v"][:, 0, :n].to(cell.device)})
    return items


def slot_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst |prog - ref| / |ref| over the (layer, slot) vectors."""
    d = (prog.float() - ref).flatten(2).norm(dim=-1)
    r = ref.flatten(2).norm(dim=-1).clamp(min=1e-30)
    return float((d / r).max())


def judged_slots(settled: torch.Tensor) -> torch.Tensor:
    """(layers, S) bool: slot s is judged at layer l where every slot
    t <= s was ``settled`` at every layer below l."""
    ok = settled.to(torch.int32)
    below = torch.ones_like(ok)
    below[1:] = ok[:-1].cumprod(0)
    return below.cumprod(1).bool()


def judge(run: dict, items: list[dict], reference,
          at: dict | None = None) -> dict:
    """The compared numbers.  ``reference(tokens) -> (K, V)``, each
    (layers, S, kv_heads, head_dim) f32, or ``(K, V, settled)`` with
    settled (layers, S) bool.  ``at`` ({number: layer}, ``layers``): a
    reference's own numbers, each the pooled error of its layer."""
    at = at or {}
    dev = run["cell"].device
    by_name: dict[str, list] = {}
    for it in items:
        by_name.setdefault(it["name"], []).append(it)
    head = slot = 0.0
    sq_d = sq_r = 0.0
    prefix_diff = rows = slots = 0
    judged_n = 0            # judged slots by layer, summed over the rows
    for name, its in sorted(by_name.items()):
        n = max(it["length"] for it in its)
        p = its[0]["prompt"]
        tokens = torch.zeros(n, dtype=torch.long, device=dev)
        tokens[:p] = prompt_token(name)
        out = reference(tokens)
        rk, rv = out[0], out[1]
        judged = judged_slots(out[2]) if len(out) > 2 else torch.ones(
            rk.shape[:2], dtype=torch.bool, device=rk.device)
        for it in its:
            ln = it["length"]
            m = judged[:, :ln]
            keep = m[:, :, None, None]
            d = r = 0.0
            for prog, ref in ((it["k"], rk[:, :ln]), (it["v"], rv[:, :ln])):
                prog = torch.where(keep, prog.float(), 0.0)
                ref = torch.where(keep, ref, 0.0)
                d = d + (prog - ref).flatten(1).square().sum(1)
                r = r + ref.flatten(1).square().sum(1)
                slot = max(slot, slot_err(prog, ref))
            seen = m[:HEAD_LAYERS].any(1)      # layer 0's always are
            head = max(head, float((d / r).sqrt()[:HEAD_LAYERS][seen].max()))
            sq_d, sq_r = sq_d + d, sq_r + r
            judged_n = judged_n + m.sum(1)
            rows += bool(m.any())
            slots += ln
        del rk, rv, out
        staged = [it for it in its if it["src"] == "pool"]
        if staged:
            s = staged[0]
            for it in its:
                if it["src"] == "row" and not (
                        torch.equal(it["k"][:, :p], s["k"][:, :p])
                        and torch.equal(it["v"][:, :p], s["v"][:, :p])):
                    prefix_diff += 1
    if not items:
        return {"kv_head_err": head, "kv_err": 0.0, "prefix_diff": 0,
                "rows_judged": 0, "judged_share": 0.0, "kv_slot_err": slot,
                "kv_layers": [], "judged_layers": [],
                **{n: None for n in at}}
    pooled = (sq_d / sq_r).sqrt()
    seen = judged_n > 0
    return {"kv_head_err": head, "kv_err": float(pooled[seen].mean()),
            "prefix_diff": prefix_diff, "rows_judged": rows,
            "judged_share": int(judged_n.sum()) / (slots * len(judged_n)),
            "kv_slot_err": slot,
            "kv_layers": [round(float(x), 5) if j else None
                          for x, j in zip(pooled, seen)],
            "judged_layers": [round(float(x) / slots, 4)
                              for x in judged_n],
            **{n: float(pooled[i]) if seen[i] else None
               for n, i in at.items()}}


def bookkeeping(run: dict) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.serving.request import State
    unplugs = [u for us in run["unplugs"] for u in us]
    freed = 0
    for u in unplugs:
        freed += abs(u["reclaimed_bytes"] - u["dropped_bytes"])
        if u["freed_bytes"] is not None:
            freed += abs(u["freed_bytes"] - u["reclaimed_bytes"])
    return {
        "clock_ahead": len(run["runner"].clock_excess),
        "migrated": sum(u["migrated_bytes"] for u in unplugs)
        + ops.LAUNCHES["kv_compact"],
        "freed_diff": freed,
        "killed": sum(r.req.state is State.KILLED
                      for r in run["runner"].recs),
    }


def verdict(numbers: dict, limits: dict = LIMITS) -> tuple[bool, dict]:
    """(correct, {name: [number, limit or floor]}): each number at or
    under its limit (``limits``: the configuration's, ``LIMITS`` for a
    dense one; a number that could not be read, ``None``, is not), and at
    or above its floor (``FLOORS``)."""
    shown = {k: [numbers[k], limits[k]] for k in limits}
    shown.update({k: [numbers[k], FLOORS[k]] for k in FLOORS})
    ok = all(numbers[k] is not None and numbers[k] <= limits[k]
             for k in limits) \
        and all(numbers[k] >= FLOORS[k] for k in FLOORS)
    return ok, shown
