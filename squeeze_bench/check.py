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
run in the configuration's type.  ``decoder`` is the plain published
dense block in bf16, with the norms, RoPE angles and softmax in f32 and
the matmuls accumulating in f32.  Numbers compared, each with its limit
(``LIMITS``):
  kv_head_err   worst over the judged rows of |program - reference| /
                |reference| over the row's written slots, K and V, in
                each of the first ``HEAD_LAYERS`` layers (a slot written
                wrong anywhere in a row shows here);
  kv_err        the same over all judged rows and slots pooled, layer by
                layer, averaged over the layers (every layer);
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
  rows_judged   rows compared (at least one).
"""
from __future__ import annotations

import importlib
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


HEAD_LAYERS = 4         # the layers ``kv_head_err`` covers


def reference(config: dict):
    """The plain reference module that judges ``config``: the bare name in
    its ``"reference"`` key (``decoder`` where it has none) of a module
    under ``reference/``, holding ``covers(model)`` and ``kv_cache(model,
    params, tokens, dtype=...)``, whose ``covers`` accepted the file's
    ``model``.  Raises ``ValueError`` with a one-line reason otherwise."""
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
        mod.covers(config["model"])
    except NotImplementedError as e:
        raise ValueError(f"reference {name!r} does not cover this "
                         f"configuration's model: {e}") from None
    return mod


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


def judge(run: dict, items: list[dict], reference) -> dict:
    """The compared numbers.  ``reference(tokens) -> (K, V)``, each
    (layers, S, kv_heads, head_dim) f32."""
    dev = run["cell"].device
    by_name: dict[str, list] = {}
    for it in items:
        by_name.setdefault(it["name"], []).append(it)
    head = slot = 0.0
    sq_d = sq_r = 0.0
    prefix_diff = 0
    for name, its in sorted(by_name.items()):
        n = max(it["length"] for it in its)
        p = its[0]["prompt"]
        tokens = torch.zeros(n, dtype=torch.long, device=dev)
        tokens[:p] = prompt_token(name)
        rk, rv = reference(tokens)
        for it in its:
            ln = it["length"]
            d = r = 0.0
            for prog, ref in ((it["k"], rk[:, :ln]), (it["v"], rv[:, :ln])):
                d = d + (prog.float() - ref).flatten(1).square().sum(1)
                r = r + ref.flatten(1).square().sum(1)
                slot = max(slot, slot_err(prog, ref))
            head = max(head, float((d / r).sqrt()[:HEAD_LAYERS].max()))
            sq_d, sq_r = sq_d + d, sq_r + r
        del rk, rv
        staged = [it for it in its if it["src"] == "pool"]
        if staged:
            s = staged[0]
            for it in its:
                if it["src"] == "row" and not (
                        torch.equal(it["k"][:, :p], s["k"][:, :p])
                        and torch.equal(it["v"][:, :p], s["v"][:, :p])):
                    prefix_diff += 1
    layers = (sq_d / sq_r).sqrt() if items else torch.zeros(1)
    return {"kv_head_err": head, "kv_err": float(layers.mean()),
            "prefix_diff": prefix_diff, "rows_judged": len(items),
            "kv_slot_err": slot,
            "kv_layers": [round(float(x), 5) for x in layers]}


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
    """(correct, {name: [number, limit]}): each number at or under its
    limit, and at least one row judged."""
    shown = {k: [numbers[k], limits[k]] for k in limits}
    shown["rows_judged"] = [numbers["rows_judged"], 1]
    ok = all(numbers[k] <= limits[k] for k in limits) \
        and numbers["rows_judged"] >= 1
    return ok, shown
